"""The 90th percentile of every request of the window, from its send to
its full answer at the client; a failed request counts as missing it
(`serve_cell.latency_p90`)."""

UNIT = "s"


def read(run):
    return run.get("latency_p90_s")
