"""Array layer: the program's op events (``trace.log_op``, one per
BlockArray dispatch) in the traced window, per call."""


def read(run):
    if run.op_events is None or not run.calls:
        return None
    return run.op_events / run.calls
