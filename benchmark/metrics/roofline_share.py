"""Kernels layer: the call's least time on its chips over the device's
busy time per call, in %. The least time is the larger of the bytes and
the operations over the card's peaks (``harness/roofline.py``), counted
from the call's shapes (the work the operation needs, whatever kernels
run it), spread over the chips; the busy time is the union of the device
operations' intervals in the traced window, averaged over the chips."""


def read(run):
    if not run.busy_s or not run.calls:
        return None
    return 100.0 * run.least_s / (run.busy_s / run.calls)
