"""Set-up: from the process's start to the first timed step or request,
the warm-up included."""

UNIT = "s"


def read(run):
    return run.get("setup_s")
