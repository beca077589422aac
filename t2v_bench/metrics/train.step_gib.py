"""What a training step adds to the state at its peak: the activations
the remat policy keeps, the gradients and the workspace.  The largest
peak of a step's span (`RunRecord.peaks`) less the state between steps."""

UNIT = "GiB"


def read(run):
    steps = [p for span, p in run.get("spans", ())
             if span.startswith("step ")]
    if not steps or not run.get("state_bytes"):
        return None
    return (max(steps) - run["state_bytes"]) / 2 ** 30
