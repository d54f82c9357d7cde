"""setup_s: from the harness's first import to the first timed op:
imports, the kernel library, the sessions, the warm-up."""

LAYER = "end to end"


def read(run):
    return run.setup_s
