"""The VAE decode's share of the card's time in the untraced window's
batches: the device seconds of their `pipeline.decode` spans over those
of the `serve.batch` spans that hold them.  The window's batches are the
first `stats.batches` `serve.batch` spans of the newest serving run."""

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
    ids = {s.id for s in batches}
    decode = [s.device_s for s in spans
              if s.name == "pipeline.decode" and s.parent in ids]
    whole = [s.device_s for s in batches]
    if not decode or None in decode or None in whole:
        return None
    return 100.0 * sum(decode) / sum(whole)
