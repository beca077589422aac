"""The training run's peak device memory: the largest span of the run
record's peaks (`RunRecord.peaks`, `max_memory_allocated` per span)."""

UNIT = "GiB"


def read(run):
    peak = run.get("memory_peak_bytes")
    return peak / 2 ** 30 if peak else None
