"""From the start of the run's process to the first timed call: imports,
the CUDA context, the program's kernel library, the inputs and the
warm-up (host clock)."""


def read(run):
    return run.setup_s
