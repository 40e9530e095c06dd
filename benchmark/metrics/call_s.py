"""All of the window's time over the user calls completed in it (host
clock; each call ended by a synchronize, on the mesh by the barrier)."""


def read(run):
    return run.window_s / run.calls if run.calls else None
