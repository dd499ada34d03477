"""Device: the share of the traced slice in which no operation ran on the
card (one minus the union of kernel and copy intervals over the slice),
in %."""


def read(w):
    if w.trace is None or not w.trace.kernels:
        return None
    return 100.0 * (1.0 - w.trace.busy_s() / w.trace.window_s)
