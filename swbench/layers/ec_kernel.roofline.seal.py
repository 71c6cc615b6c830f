"""``ec_kernel.roofline.seal``: the EC kernels' share of the card's memory
bound over the window's seals and rebuilds. The bytes come from the
volume's shapes (14 shards of the volume's shard size, read or written
once, per generate and per rebuild), so they count the same work whatever
implements it; the time is every kernel's device time in the window, from
the profiler's trace."""


def read(run):
    dev, work = run["device"], run["work"].get("ec_kernel_bytes")
    peak = run["peaks"].get("hbm_bytes_per_s")
    if not dev or not dev["kernel_s"] or not work or not peak:
        return None
    return 100.0 * work / peak / dev["kernel_s"]
