"""``torch.cuda.max_memory_allocated()`` over set-up and window, of the
fullest card, in GB (1e9 bytes); nothing where no card was used."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
