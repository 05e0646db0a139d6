"""segs_per_sample: traced segments (render_image's aux
`traced_segments`: live closest hits, shadow rays and live chain trips)
over the traced passes' pixel samples. A count of work done. Layer: the
shade tree (levels and chain trips)."""


def read(ctx):
    if ctx["kind"] != "progressive" or not ctx["units"]:
        return None
    return ctx["segments"] / (ctx["units"] * ctx["pixels"])
