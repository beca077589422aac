"""Attention calls on the plain path per UNet call: the plain-path calls
of the program's counter (`ops/attention.py::head_dim_counts`, by path and
head_dim) over the UNet calls of the newest serving run, counted from its
`unet.motion` spans (the configuration's motion modules a call: 21 at SD
1.5's geometry).  The counter holds the process's calls, the run's only:
its warm-up, window and traced batches, whose UNet calls all take the
same paths.  A program without the counter, or a UNet without motion
modules, reads nothing."""

UNIT = "calls"


def motion_modules_per_call(unet: dict) -> int:
    """Motion modules in one call of a published UNetMotionModel config:
    a down block's `layers_per_block`, an up block's one more, and the mid
    block's."""
    if unet.get("_class_name") != "UNetMotionModel":
        return 0
    levels = len(unet["block_out_channels"])
    per = unet["layers_per_block"]
    return levels * per + levels * (per + 1) + \
        int(bool(unet.get("use_motion_mid_block", True)))


def read(run):
    try:
        from text_to_video_finetuning_tpu_torch.ops import attention
        from text_to_video_finetuning_tpu_torch.utils import profiling
        counts = attention.head_dim_counts
        spans = profiling.newest_run(profiling.spans(), "serve")
    except (ImportError, AttributeError):
        return None
    per_call = motion_modules_per_call((run.get("config") or {})
                                       .get("unet", {}))
    motion = sum(s.name == "unet.motion" for s in spans)
    if not per_call or not motion or motion % per_call:
        return None
    plain = sum(n for (path, _), n in counts.items() if path == "plain")
    return plain / (motion // per_call)
