"""``device.idle_share.read``: the share of the window in which the card ran
no kernel, copy or memset (the union of their intervals, from the
profiler's trace), in the cells that serve reads."""


def read(run):
    dev = run["device"]
    if not dev or not dev["window_s"]:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
