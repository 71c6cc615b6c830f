"""``query_kernels.roofline.read``: the scan's kernels (``query/scan.py``
``TorchKernels``) against the card's memory bound: the stored bytes of the
objects whose queries were answered in the window, read once, over every
kernel's device time in the window, from the profiler's trace."""


def read(run):
    dev, work = run["device"], run["work"].get("query_bytes_scanned")
    peak = run["peaks"].get("hbm_bytes_per_s")
    if not dev or not dev["kernel_s"] or not work or not peak:
        return None
    return 100.0 * work / peak / dev["kernel_s"]
