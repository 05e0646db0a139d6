"""device_idle_pct.train: 100 minus the union of the device's kernel,
copy and set intervals over the traced window of inverse-rendering steps,
in percent of the window. Layer: the device."""


def read(ctx):
    if ctx["kind"] != "inverse" or ctx["trace"].window_s <= 0.0:
        return None
    return 100.0 * (1.0 - ctx["trace"].busy_s / ctx["trace"].window_s)
