"""Entry layer: the mean host time from the entry call to its return,
before the synchronize: the host's time to issue one call. A sync hidden
in the path shows here."""


def read(run):
    if not run.enqueue_s:
        return None
    return 1e3 * sum(run.enqueue_s) / len(run.enqueue_s)
