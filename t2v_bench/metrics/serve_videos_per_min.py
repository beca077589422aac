"""Videos answered over HTTP in the window, over the window: the clients
stop sending after the window's seconds and the window closes with the
last answer, so it holds whole batches."""

UNIT = "videos/min"


def read(run):
    w = run["window"]
    if "requests" not in w or w["seconds"] <= 0:
        return None
    return 60.0 * w["requests"] / w["seconds"]
