"""The training state the card holds between steps: device memory
allocated at the window's first step boundary (after a synchronize):
the frozen weights, the LoRA tensors, AdamW's moments."""

UNIT = "GiB"


def read(run):
    state = run.get("state_bytes")
    return state / 2 ** 30 if state else None
