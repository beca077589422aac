"""Model FLOP utilisation of the untraced window: the model FLOPs of
every request served in it (`workload.request`, counted from the
configuration's shapes), over the window's seconds and the card's dense
bf16 peak."""

from t2v_bench.workload import request

UNIT = "%"


def read(run):
    w = run["window"]
    if not run.get("peaks") or not w.get("requests"):
        return None
    g = run["request"]
    flops, _ = request(run["config"], g["num_frames"], g["height"],
                       g["width"], g["num_steps"])
    return 100.0 * flops * w["requests"] / w["seconds"] \
        / run["peaks"]["flops"]
