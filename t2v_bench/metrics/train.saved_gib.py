"""What the remat policy keeps for the backward: the most device memory a
forward of the window's steps leaves allocated (`engine.forward`'s
`allocated`), less the state the card holds between steps.  The window's
steps are the `window.steps` step spans before the traced ones."""

UNIT = "GiB"


def read(run):
    try:
        from text_to_video_finetuning_tpu_torch.utils import profiling
        spans = profiling.newest_run(profiling.spans(), "train")
    except (ImportError, AttributeError):
        return None
    steps = sorted((s for s in spans if s.name == "engine.step"),
                   key=lambda s: s.attrs["step"])
    n, traced = run["window"]["steps"], run.get("traced_steps", 0)
    if not n or len(steps) < n + traced or not run.get("state_bytes"):
        return None
    window = {s.id for s in steps[len(steps) - traced - n:
                                  len(steps) - traced]}
    kept = [s.attrs["allocated"] for s in spans
            if s.name == "engine.forward" and s.parent in window
            and "allocated" in s.attrs]
    return (max(kept) - run["state_bytes"]) / 2 ** 30 if kept else None
