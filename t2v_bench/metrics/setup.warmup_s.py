"""Set-up's warm-up in the newest run of the cell's kind: in training the
steps before the window (`engine.step`) with their batches
(`engine.data`), in serving `serve.setup.warmup`; the first run of a
checkout builds the kernels inside it (`kernel.build`)."""

UNIT = "s"


def read(run):
    try:
        from text_to_video_finetuning_tpu_torch.utils import profiling
        spans = profiling.newest_run(profiling.spans(), run["kind"])
    except (ImportError, AttributeError):
        return None
    if run["kind"] == "serve":
        found = [s.seconds for s in spans if s.name == "serve.setup.warmup"]
        return sum(found) if found else None
    steps = sorted((s for s in spans if s.name == "engine.step"),
                   key=lambda s: s.attrs["step"])
    warm = len(steps) - run["window"]["steps"] - run.get("traced_steps", 0)
    if not run["window"]["steps"] or warm <= 0:
        return None
    numbers = {s.attrs["step"] for s in steps[:warm]}
    return sum(s.seconds for s in steps[:warm]) + sum(
        s.seconds for s in spans
        if s.name == "engine.data" and s.attrs.get("step") in numbers)
