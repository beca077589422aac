"""Published peaks by card name: dense bf16 FLOP/s and HBM bytes/s (NVIDIA's
H100 data sheet, SXM part, at its 700 W limit; the result line records the
card's power limit beside every share of them).  A card not in the table
has no peak, and no share of one is reported."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops": 989e12, "bytes_per_s": 3.35e12},
}


def of(kind: str):
    return PEAKS.get(kind)
