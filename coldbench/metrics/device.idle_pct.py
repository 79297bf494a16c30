"""Share of the traced device window in which no operation (kernel, copy
or fill) ran on the card: one minus the union of the profiler's device
intervals over the window's length, in %."""


def read(run):
    tr = run["trace"]
    if tr is None or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
