"""setup_s (s): process start to the first step of the window, on the
host's clock: imports, the kernels loaded (built in a checkout's first
run), the seeded weights, and the warm-up stream that plans every
bucket."""


def read(run):
    return run.setup_s
