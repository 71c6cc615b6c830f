"""``seal_rebuild_device_GBps``: the .dat bytes that the window's seals and
rebuilds put through the card (the whole .dat once for each generate, and
once for each rebuild, which reads the ten surviving shards), over the
card's busy time in the window: the union of its kernel, copy and memset
intervals, from the profiler's trace. The host's legs of a cycle are in
``seal_rebuild_wall_GBps``."""


def read(run):
    dev, work = run["device"], run["work"].get("seal_rebuild_bytes")
    if not dev or not dev["busy_s"] or not work:
        return None
    return work / dev["busy_s"] / 1e9
