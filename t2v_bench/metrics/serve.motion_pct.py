"""The motion modules' share of the denoise loop's card time in the
untraced window's batches: the device seconds of the `unet.motion` spans
(one a motion module call) over those of the `pipeline.denoise` spans
that hold them.  The window's batches are the first `stats.batches`
`serve.batch` spans of the newest serving run; a UNet without motion
modules reads nothing."""

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
    denoise = [s for s in spans
               if s.name == "pipeline.denoise" and s.parent in ids]
    loops = {s.id for s in denoise}
    motion = [s.device_s for s in spans
              if s.name == "unet.motion" and s.parent in loops]
    whole = [s.device_s for s in denoise]
    if not motion or not whole or None in motion or None in whole:
        return None
    return 100.0 * sum(motion) / sum(whole)
