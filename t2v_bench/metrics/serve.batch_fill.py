"""How full the worker's batches ran in the untraced window: requests over
batches over `max_batch`, from the difference of the server's counters
(`BatchingWorker.stats`) across the window."""

UNIT = "share"


def read(run):
    stats = run.get("stats")
    if not stats or not stats["batches"]:
        return None
    return stats["requests"] / stats["batches"] / run["max_batch"]
