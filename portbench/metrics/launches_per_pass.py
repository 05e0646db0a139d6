"""launches_per_pass: CUDA kernel launches by the host (the profiler's
cudaLaunchKernel / cuLaunchKernel events) over the traced passes, per
pass. Layer: the render loop and shade tree (models/pathtracer.py)."""


def read(ctx):
    if ctx["kind"] != "progressive" or not ctx["units"]:
        return None
    return ctx["trace"].launches / ctx["units"]
