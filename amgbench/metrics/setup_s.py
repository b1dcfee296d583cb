"""setup_s: seconds from the start of the run to the end of the warm request."""


def read(run):
    return run.setup_s
