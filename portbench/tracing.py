"""The reduction of one torch.profiler trace to the numbers the per-layer
metrics read.

Launches are counted as the `cudaLaunchKernel` / `cuLaunchKernel` runtime
events of the host (as chip_smoke.py's `profile_counts` counts them); device time
is that of the events that ran on the card (kernels, copies and sets), by
name; the device's busy time is the union of their intervals, so that
overlapping work counts once; the traced window is the host's wall from
the start of the traced work to its end, after a synchronise.

Idle gaps are the stretches of the window with no device event. Each is
named by what the host was doing at its middle: the outermost operator
(`aten::...`) running then, or "host python" where none was.
"""

from __future__ import annotations

import dataclasses

import numpy as np

LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel")
WINDOW = "portbench.window"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    launches: int
    device_ops: dict  # name -> [count, seconds]
    idle_by_host: dict  # host op -> seconds of device idle

    def device_seconds(self, match) -> float:
        """Device seconds of the ops whose name `match(name)` accepts."""
        return sum(s for name, (_, s) in self.device_ops.items() if match(name))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1][1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[name[:160], sec] for name, (_, sec) in ops],
                "idle_gaps": [[name[:160], sec] for name, sec in gaps]}


def union_length(starts: np.ndarray, ends: np.ndarray, lo: float, hi: float):
    """(length of the union of [starts, ends) clipped to [lo, hi), the
    (gap starts, gap ends) of the window not covered)."""
    s = np.clip(np.asarray(starts, np.float64), lo, hi)
    e = np.clip(np.asarray(ends, np.float64), lo, hi)
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    # The running maximum of the ends: an interval starts a new covered
    # stretch where it begins after every earlier one has ended.
    run = np.maximum.accumulate(e) if e.size else e
    prev_end = np.concatenate([[lo], run[:-1]]) if e.size else np.array([lo])
    new = s > prev_end
    gap_s = np.concatenate([prev_end[new], [run[-1] if e.size else lo]])
    gap_e = np.concatenate([s[new], [hi]])
    gaps = gap_e > gap_s
    gap_s, gap_e = gap_s[gaps], gap_e[gaps]
    return (hi - lo) - float(np.sum(gap_e - gap_s)), gap_s, gap_e


def _outermost(starts, ends):
    """The intervals not inside an earlier one (sorted by start)."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    keep = np.ones(s.size, bool)
    reach = -np.inf
    for i in range(s.size):
        if s[i] < reach and e[i] <= reach:
            keep[i] = False
        else:
            reach = max(reach, e[i])
    return order[keep]


def reduce_events(events, t_lo_ns: int, t_hi_ns: int) -> Trace:
    """A Trace of the raw profiler events (prof.profiler.kineto_results
    .events()) in the host window [t_lo_ns, t_hi_ns)."""
    from torch.autograd import DeviceType

    launches = 0
    dev_s, dev_e, dev_names = [], [], []
    host_s, host_e, host_names = [], [], []
    for ev in events:
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if ev.is_user_annotation():
                continue
            s = ev.start_ns()
            dev_s.append(s)
            dev_e.append(s + ev.duration_ns())
            dev_names.append(name)
            continue
        if name in LAUNCH_KEYS:
            launches += 1
        elif name.startswith("aten::"):
            s = ev.start_ns()
            host_s.append(s)
            host_e.append(s + ev.duration_ns())
            host_names.append(name)
    device_ops: dict = {}
    for name, s, e in zip(dev_names, dev_s, dev_e):
        c = device_ops.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += (e - s) * 1e-9
    busy_ns, gs, ge = union_length(np.array(dev_s, np.float64), np.array(dev_e, np.float64),
                                   float(t_lo_ns), float(t_hi_ns))
    idle: dict = {}
    if gs.size:
        hs, he = np.array(host_s, np.float64), np.array(host_e, np.float64)
        top = _outermost(hs, he) if hs.size else np.zeros(0, np.int64)
        ts, te = hs[top], he[top]
        mid = (gs + ge) / 2.0
        i = np.searchsorted(ts, mid, side="right") - 1
        inside = (i >= 0) & (te[np.clip(i, 0, None)] > mid) if ts.size else np.zeros(mid.size, bool)
        for k in range(mid.size):
            label = host_names[top[i[k]]] if inside[k] else "host python"
            idle[label] = idle.get(label, 0.0) + (ge[k] - gs[k]) * 1e-9
    return Trace(window_s=(t_hi_ns - t_lo_ns) * 1e-9, busy_s=busy_ns * 1e-9,
                 launches=launches, device_ops=device_ops,
                 idle_by_host=idle)


def traced(fn, sync):
    """(fn(), Trace) of one call under torch.profiler (host and device),
    the window the span of a "portbench.window" range around the call and
    a closing `sync()`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sync()
        with record_function(WINDOW):
            out = fn()
            sync()
    events = [ev for ev in prof.profiler.kineto_results.events()]
    win = [ev for ev in events if ev.name() == WINDOW
           and ev.device_type() != DeviceType.CUDA]
    lo = win[0].start_ns()
    hi = lo + win[0].duration_ns()
    return out, reduce_events([ev for ev in events if ev.name() != WINDOW], lo, hi)
