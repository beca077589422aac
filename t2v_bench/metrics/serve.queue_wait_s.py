"""How long a request of the untraced window waited before its batch
started: the median of its `serve.queue` span, from its submit to its
batch's start.  The window's batches are the first `stats.batches`
`serve.batch` spans of the newest serving run (the warm-up makes none),
its requests theirs."""

import statistics

UNIT = "s"


def read(run):
    try:
        from text_to_video_finetuning_tpu_torch.utils import profiling
        spans = profiling.newest_run(profiling.spans(), "serve")
    except (ImportError, AttributeError):
        return None
    n = (run.get("stats") or {}).get("batches")
    batches = sorted((s for s in spans if s.name == "serve.batch"),
                     key=lambda s: s.attrs["batch"])[:n]
    if not n or len(batches) < n:
        return None
    requests = {r for s in batches for r in s.attrs["requests"]}
    waits = [s.seconds for s in spans
             if s.name == "serve.queue" and s.attrs["request"] in requests]
    return statistics.median(waits) if waits else None
