"""The share of the untraced window in which the worker ran no batch: one
less the window's `serve.batch` seconds over the time from the first
window request's submit (its `serve.queue` start) to the last window
batch's end.  The window's batches are the first `stats.batches`
`serve.batch` spans of the newest serving run."""

UNIT = "%"


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
    submits = [s.start for s in spans
               if s.name == "serve.queue" and s.attrs["request"] in requests]
    if not submits:
        return None
    whole = max(s.end for s in batches) - min(submits)
    return 100.0 * (1.0 - sum(s.seconds for s in batches) / whole)
