"""The benchmark of bhraytracer_tpu_torch: one cell a run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of BENCHMARK.json's `workloads`; it names a
configuration (portbench/configs/<name>.json: the scene and its render
depths), a traffic mix (portbench/traffic/<name>.json: what one unit of
work is, its sizes, and the `kind` of loop that drives it,
portbench/loops/<kind>.py) and the limits of its output check
(portbench/limits/<cell>.json). Each per-layer metric is a reader of its
own, portbench/metrics/<name>.py, found by the metric's name. A new scene,
mix, limit or metric is a new file; nothing shared lists them.

The run prints, as the last line of its standard output, one JSON object:
correct, attempted, failed, metrics, device, with --trace 1 breakdown, and
last `checks`, each number the output check compared beside its limit.
The same numbers are the last lines of its standard error.

It refuses to run (exit 3, no result) without as many cards as the cell
asks for, and (exit 4, no result) where jax, jaxlib, flax or the JAX
package were loaded into the process.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "bhraytracer_tpu")


def process_age_s(fallback_start: float) -> float:
    """Seconds since this process started, from /proc (the kernel's start
    time in clock ticks against the uptime); the perf_counter since
    `fallback_start` where /proc is not there."""
    import time

    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - fallback_start


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (bhraytracer_tpu_torch is not bhraytracer_tpu)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def cell_spec(bench: dict, workload: str):
    """(cell, end-to-end metric specs, per-layer metric specs) of one cell:
    the end-to-end metrics that list the cell or list none, and the
    per-layer metrics that list it, or that list none and move an
    end-to-end metric the cell reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return cells[workload], e2e, layer


def cards() -> int:
    """The CUDA devices this process sees (0 without CUDA)."""
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def device_name() -> str:
    import torch

    return torch.cuda.get_device_name(0)


def device_line(chips: int, peak: int) -> dict:
    return {"platform": "gpu", "kind": device_name(), "count": chips,
            "memory_peak_bytes": int(peak)}


def card_state() -> str:
    """nvidia-smi's name, power limit and draw, SM clock and temperature."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float, device: str = "cuda") -> int:
    args = parse(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    cell, e2e, layer = cell_spec(bench, args.workload)
    config = load_json(HERE, "configs", cell["config"] + ".json")
    traffic = load_json(HERE, "traffic", cell["traffic"] + ".json")
    limits = load_json(HERE, "limits", cell["name"] + ".json")
    loop = importlib.import_module("portbench.loops." + traffic["kind"])

    # Build and kernel caches stay inside the checkout, at fixed paths.
    build = os.path.join(ROOT, "build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("USE_FLAX", "0")

    import torch

    n = cards()
    if n < cell["chips"]:
        print(f"portbench: {cell['chips']} CUDA device(s) wanted, {n} found", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    run = loop.Run(root=ROOT, config=config, traffic=traffic, limits=limits,
                     seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                     setup_clock=lambda: process_age_s(t_start), device=device)
    res = run.go()

    bad = forbidden_modules()
    if bad:
        print("portbench: modules of JAX or the JAX package were loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 4

    metrics = {}
    if args.trace:
        ctx = dict(res.layer_ctx, config=config, traffic=traffic, cell=cell)
        for m in layer:
            reader = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"),
                                 "portbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            if m["name"] in res.e2e:
                metrics[m["name"]] = {"value": res.e2e[m["name"]], "unit": m["unit"]}
    device = device_line(cell["chips"], res.memory_peak_bytes)
    if args.trace:
        device.update(busy_s=res.trace.busy_s, window_s=res.trace.window_s)
    print(f"portbench: card {card_state()}", file=sys.stderr)
    for k, v in res.notes.items():
        print(f"portbench: {k} {v}", file=sys.stderr)
    for name, c in res.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    out = {"correct": res.correct, "attempted": res.attempted, "failed": res.failed,
           "metrics": metrics, "device": device}
    if args.trace:
        out["breakdown"] = res.trace.breakdown()
    out["checks"] = res.checks
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
