"""Readings from /proc of what the host did during a run's window: its
clock, the time stolen from its cores, the time the main thread waited
for a core. A one-chip machine shares its host's cores, and the passes
and steps are paced by the host, so these readings say why two runs'
rates differ, where the host reports them. Nothing is changed.
"""

from __future__ import annotations

import os
import time


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def snapshot() -> dict:
    """The host's counters now: steal and idle ticks of all cores
    (/proc/stat), the main thread's seconds on a core and waiting for one
    (/proc/thread-self/schedstat), and the clock of the core it runs on
    in MHz (/proc/cpuinfo)."""
    out = {"t": time.perf_counter()}
    for line in _read("/proc/stat").splitlines():
        f = line.split()
        if f and f[0] == "cpu" and len(f) > 8:
            out["idle_ticks"] = int(f[4])
            out["steal_ticks"] = int(f[8])
            break
    sched = _read("/proc/thread-self/schedstat").split()
    if len(sched) >= 2:
        out["run_s"] = int(sched[0]) / 1e9
        out["wait_s"] = int(sched[1]) / 1e9
    mhz = [float(line.split(":")[1]) for line in _read("/proc/cpuinfo").splitlines()
           if line.startswith("cpu MHz")]
    core = os.sched_getcpu() if hasattr(os, "sched_getcpu") else 0
    if mhz:
        out["mhz"] = mhz[core if core < len(mhz) else 0]
    return out


def delta(a: dict, b: dict) -> dict:
    """What the host did between two snapshots: the wall, the main
    thread's share of it on a core and waiting for one, the steal and the
    idle of all cores in core-seconds, and the clock at both ends."""
    tick = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100
    wall = b["t"] - a["t"]
    out = {"wall_s": wall}
    if "run_s" in a and "run_s" in b:
        out["main_on_core_s"] = b["run_s"] - a["run_s"]
        out["main_waiting_s"] = b["wait_s"] - a["wait_s"]
    if "steal_ticks" in a and "steal_ticks" in b:
        out["steal_core_s"] = (b["steal_ticks"] - a["steal_ticks"]) / tick
        out["idle_core_s"] = (b["idle_ticks"] - a["idle_ticks"]) / tick
    if "mhz" in a and "mhz" in b:
        out["mhz"] = [a["mhz"], b["mhz"]]
    out["cores"] = os.cpu_count()
    return out
