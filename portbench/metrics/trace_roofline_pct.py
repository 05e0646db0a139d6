"""trace_roofline_pct: the least time the traced passes' traces could
take (portbench/roofline.py:trace_bytes at HBM_RATE: each segment's ray
read and hit written once, the scene once a pass) over the profiler's
device time of the trace kernels (closest and any-hit: the BVH, stream and
grouped-stream kernels, and the analytic ones), in percent. Nothing where
no trace kernel ran. Layer: the trace kernels."""

from portbench import roofline

TRACE_KERNELS = ("cull_closest_kernel", "cull_anyhit_kernel", "bvh_closest_kernel",
                 "bvh_anyhit_kernel", "analytic_closest_kernel", "analytic_anyhit_kernel")


def is_trace_kernel(name: str) -> bool:
    return any(k in name for k in TRACE_KERNELS)


def read(ctx):
    if ctx["kind"] != "progressive" or not ctx["units"]:
        return None
    seconds = ctx["trace"].device_seconds(is_trace_kernel)
    if seconds <= 0.0:
        return None
    tri, sph, pln = ctx["scene_counts"]
    n_bytes = roofline.trace_bytes(ctx["segments"], tri, sph, pln, passes=ctx["units"])
    return 100.0 * roofline.least_seconds(n_bytes) / seconds
