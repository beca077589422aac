"""The long attentions' share of their roofline in the traced serving
window: the forward work of every attention at 1,024 tokens or more of
the requests served there (`workload.attn_work`, counted from the call
shapes), as the least time the card could take, over the device time of
the kernels that implement them, found by name: the program's flash
kernels and the library's fused attention."""

import re

from t2v_bench.trace import seconds_matching
from t2v_bench.workload import attn_work, request

UNIT = "%"
PATTERN = re.compile(r"flash_(fwd|bwd|dkv|dq)_|fmha|flash_attn|"
                     r"efficient_attention|attention_kernel", re.I)


def read(run):
    trace = run.get("trace")
    if not trace or not run.get("peaks") or not run.get("traced_requests"):
        return None
    seconds = seconds_matching(trace, PATTERN)
    if seconds <= 0:
        return None
    g = run["request"]
    _, calls = request(run["config"], g["num_frames"], g["height"],
                       g["width"], g["num_steps"])
    work = attn_work(calls, backward=False)
    bound = run["traced_requests"] * max(
        work["flops"] / run["peaks"]["flops"],
        work["bytes"] / run["peaks"]["bytes_per_s"])
    return 100.0 * bound / seconds
