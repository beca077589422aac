"""Set-up's model load: the seconds of the program's load spans in the
newest run of the cell's kind, `engine.setup.models` (the load and the
casts) in training, `serve.setup.load` (the pipeline) in serving."""

UNIT = "s"
SPANS = {"train": "engine.setup.models", "serve": "serve.setup.load"}


def read(run):
    try:
        from text_to_video_finetuning_tpu_torch.utils import profiling
        spans = profiling.newest_run(profiling.spans(), run["kind"])
    except (ImportError, AttributeError):
        return None
    found = [s.seconds for s in spans if s.name == SPANS[run["kind"]]]
    return sum(found) if found else None
