"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program (top-level module names
compared whole: bhraytracer_tpu_torch is not bhraytracer_tpu). Each
check runs in a fresh interpreter."""

import json
import subprocess
import sys

from portbench import harness

PROBE = r"""
import json, sys
sys.path.insert(0, {root!r})
{body}
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps(tops))
"""


def loaded(body: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=harness.ROOT, body=body)],
                         capture_output=True, text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_modules_import_no_jax():
    tops = loaded("import portbench.harness, portbench.tracing, portbench.roofline, "
                  "portbench.checks, portbench.control, portbench.program, portbench.host, "
                  "portbench.loops.progressive, portbench.loops.inverse")
    assert not tops & set(harness.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    tops = loaded(
        "import torch\n"
        "from portbench import harness\n"
        "from portbench.reference import render, scene, train\n"
        "cfg = harness.load_json(harness.HERE, 'configs', 'cornell_glass.json')\n"
        "r = render.Renderer(scene.build_scene(cfg, harness.ROOT, 'cpu'), 16, 12)\n"
        "r.render_pass(5, 0, render.Settings(**cfg['render']))\n")
    assert not tops & (set(harness.FORBIDDEN) | {"bhraytracer_tpu_torch"})


def test_a_run_loads_no_jax():
    """A whole run of the harness on the CPU, the card check skipped: the
    run refuses to print a result (exit 4) where JAX was loaded."""
    body = (
        "from portbench import harness\n"
        "harness.cards = lambda: 1\n"
        "harness.device_name = lambda: 'cpu'\n"
        "orig = harness.load_json\n"
        "def lj(*p):\n"
        "    d = orig(*p)\n"
        "    return dict(d, width=24, height=16) if p[-2:-1] == ('traffic',) else d\n"
        "harness.load_json = lj\n"
        "import contextlib, io\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        "    rc = harness.main(['--workload', 'cornell_glass.render_2160p', '--seed', '9', "
        "'--seconds', '0.1', '--trace', '0'], 0.0, device='cpu')\n"
        "assert rc == 0 and json.loads(buf.getvalue().splitlines()[-1])['attempted'] >= 1\n")
    tops = loaded(body)
    assert "bhraytracer_tpu_torch" in tops and not tops & set(harness.FORBIDDEN)
