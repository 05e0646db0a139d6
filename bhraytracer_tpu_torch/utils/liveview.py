"""Live render view over HTTP (a copy of bhraytracer_tpu/utils/liveview.py)
— the headless replacement for the reference viewport's in-progress window
(viewport.cpp:94-139 creates the GLUT window; 344-391 redraws the partial
render as scanlines finish; keys 1-5 switch between the GL preview /
rendered image / z-buffer / sample-count views, viewport.cpp:419-485).

A daemon thread serves:
  /              tiny HTML page that re-fetches the image ~1 Hz; number keys
                 (or buttons) switch between the image and registered aux
                 views — the headless analogue of the viewport's view modes
  /image.png     the current bytes of the render's output PNG (rewritten by
                 --progressive after every pass)
  /view/N.png    registered aux view PNGs (z-buffer, sample count, ...)
  /status        JSON {passes_done, spp_done, spp_total, elapsed_s, views}

stdlib http.server only; no dependencies, dies with the process.
"""

from __future__ import annotations

import http.server
import json
import os
import threading
import time

_PAGE = b"""<!doctype html>
<html><head><title>bhraytracer_tpu_torch live render</title><style>
body{background:#111;color:#ccc;font-family:monospace;text-align:center}
img{image-rendering:pixelated;max-width:95vw;max-height:82vh;
    border:1px solid #333}
button{background:#222;color:#ccc;border:1px solid #444;margin:2px;
       font-family:monospace}
button.on{border-color:#8c8}
</style></head><body>
<h3 id="s">rendering&hellip;</h3>
<div id="bar"></div>
<img id="im" src="/image.png">
<script>
let views = [];  // ['image', ...aux names]
let cur = 'image';
function src(){ return (cur == 'image' ? '/image.png' : '/view/' + cur +
                        '.png') + '?' + Date.now(); }
function setView(v){ cur = v; render(); document.getElementById('im').src =
                     src(); }
function render(){
  const bar = document.getElementById('bar');
  bar.innerHTML = '';
  views.forEach((v, i) => {
    const b = document.createElement('button');
    b.textContent = `${i + 1}:${v}`;
    b.className = (v == cur) ? 'on' : '';
    b.onclick = () => setView(v);
    bar.appendChild(b);
  });
}
document.addEventListener('keydown', e => {
  const i = e.key.charCodeAt(0) - 49;  // '1' -> 0
  if (i >= 0 && i < views.length) setView(views[i]);
});
async function tick(){
  try{
    const r = await fetch('/status'); const j = await r.json();
    document.getElementById('s').textContent =
      `pass ${j.passes_done} - ${j.spp_done}/${j.spp_total} spp - ` +
      `${j.elapsed_s.toFixed(1)}s` + (j.finished ? ' - done' : '');
    const v = ['image'].concat(j.views || []);
    if (v.join() != views.join()){ views = v; render(); }
    document.getElementById('im').src = src();
  }catch(e){}
  setTimeout(tick, 1000);
}
tick();
</script></body></html>"""


class LiveView:
    """Start with serve(); update state via note_pass(); finish().
    register_aux(name, path) adds a switchable view (z-buffer, sample
    count, ...) — the viewport's 1-5 view modes, headless."""

    def __init__(self, image_path: str, spp_total: int):
        self.image_path = image_path
        self.aux: dict = {}
        self.state = {"passes_done": 0, "spp_done": 0, "spp_total": spp_total,
                      "elapsed_s": 0.0, "finished": False}
        self._t0 = time.time()
        self._httpd = None

    def note_pass(self, passes_done: int, spp_done: int) -> None:
        self.state.update(passes_done=passes_done, spp_done=spp_done,
                          elapsed_s=time.time() - self._t0)

    def register_aux(self, name: str, path: str) -> None:
        self.aux[name] = path

    def finish(self) -> None:
        self.state.update(finished=True, elapsed_s=time.time() - self._t0)

    def serve(self, port: int) -> int:
        """Bind and serve on a daemon thread; returns the bound port."""
        view = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, "text/html", _PAGE)
                elif path == "/image.png":
                    self._send_file(view.image_path)
                elif path.startswith("/view/") and path.endswith(".png"):
                    name = path[len("/view/"):-len(".png")]
                    if name in view.aux:
                        self._send_file(view.aux[name])
                    else:
                        self._send(404, "text/plain", b"unknown view")
                elif path == "/status":
                    view.state["elapsed_s"] = (
                        view.state["elapsed_s"] if view.state["finished"]
                        else time.time() - view._t0)
                    st = dict(view.state,
                              views=[k for k, p in view.aux.items()
                                     if os.path.exists(p)])
                    self._send(200, "application/json",
                               json.dumps(st).encode())
                else:
                    self._send(404, "text/plain", b"not found")

            def _send_file(self, p):
                try:
                    with open(p, "rb") as f:
                        self._send(200, "image/png", f.read())
                except OSError:
                    self._send(404, "text/plain", b"not rendered yet")

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        self._httpd = http.server.ThreadingHTTPServer(("0.0.0.0", port),
                                                      Handler)
        th = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        th.start()
        return self._httpd.server_address[1]

    def shutdown(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None
