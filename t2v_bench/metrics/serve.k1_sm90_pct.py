"""The share of the serving process's K1 (flash-attention forward)
launches that took the Hopper `sm90` route: 100 x its `fwd` launches on
`sm90` over its `fwd` launches on both routes, from the program's counters
of launches by kernel and route (`ops/flash_attention.py::
fwd_sm90_launch_count`, `fwd_wmma_launch_count`).  The counters hold the
process's launches, the run's only: its warm-up, window and traced
batches, whose UNet calls all take the same routes.  A program without the
counters, or a run that launched no K1, reads nothing."""

UNIT = "%"


def read(run):
    try:
        from text_to_video_finetuning_tpu_torch.ops import flash_attention
        sm90 = flash_attention.fwd_sm90_launch_count
        wmma = flash_attention.fwd_wmma_launch_count
    except (ImportError, AttributeError):
        return None
    if not sm90 + wmma:
        return None
    return 100.0 * sm90 / (sm90 + wmma)
