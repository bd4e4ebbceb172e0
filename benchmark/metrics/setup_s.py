"""Set-up seconds: from the process's start to the window's (loading,
building the kernels on a checkout's first run, the warm-up fit)."""


def read(run):
    return run.setup_s
