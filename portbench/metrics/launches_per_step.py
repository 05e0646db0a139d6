"""launches_per_step: CUDA kernel launches by the host (the profiler's
cudaLaunchKernel / cuLaunchKernel events) over the traced inverse-rendering
steps, per step: the forward, autograd's backward and the Adam update.
Layer: gradients."""


def read(ctx):
    if ctx["kind"] != "inverse" or not ctx["units"]:
        return None
    return ctx["trace"].launches / ctx["units"]
