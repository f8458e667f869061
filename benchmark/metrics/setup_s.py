"""Set-up: from the process's start to the first timed request (loading,
building, making the inputs, the warm-up)."""


def read(run):
    return run.setup_s
