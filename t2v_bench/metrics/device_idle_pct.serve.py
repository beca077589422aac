"""The share of the traced serving window (whole batches and the gaps
between them) in which no operation ran on the card."""

UNIT = "%"


def read(run):
    trace = run.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
