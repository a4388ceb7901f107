"""setup_s (s): from the start of the process to the window: imports, the
card's context, the community drawn and built on the card, the kernels
loaded (built on a checkout's first run) and the warm-up."""


def read(run):
    return run.setup_s
