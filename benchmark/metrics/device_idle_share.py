"""Device layer: 1 − the union of device activity over the traced window,
in %, averaged over the chips."""


def read(run):
    if run.busy_s is None or not run.traced_window_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.traced_window_s)
