"""What a cell of requests does with its load: the closed loop's worker and
its reduction.

The window is one ``clients.closed_loop`` window of the traffic's
``streams``. ``read_MBps`` is the stored bytes of the requests answered
inside the window, over the window: a closed loop offers more than the
port sustains, so it reads what the port completes. A request's latency,
answered minus sent, goes with its percentiles to the result's ``detail``.
"""

from __future__ import annotations

import numpy as np


def start(ctx, cluster, request: str, args: dict, urls: list, items: int):
    """The closed loop's worker, warmed up: (worker, the warm-up's records)."""
    w = cluster.worker("closed_loop", request=request, args=args, urls=urls, items=items,
                       streams=ctx.traffic["streams"], seed=ctx.seed)
    return w, w.ready()["warmup"]


def window(ctx, worker) -> list:
    t0, t1 = ctx.begin_window()
    worker.go(t0, t1)
    recs = worker.window(timeout=ctx.seconds + 900)
    ctx.end_window(t1)
    return recs


def reduce(recs: list, window: tuple, stored) -> dict:
    """The end-to-end metric and the latencies of one window's records;
    ``stored(rec)`` is the bytes a request covered."""
    t0, t1 = window
    ok = [r for r in recs if r[3] == 200]
    done = [r for r in ok if r[2] <= t1]
    lat = np.array([(r[2] - r[1]) * 1e3 for r in ok]) if ok else np.zeros(1)
    return {"read_MBps": sum(stored(r) for r in done) / (t1 - t0) / 1e6,
            "requests": len(recs), "answered_in_window": len(done),
            "answered_after_window": len(ok) - len(done),
            **{f"latency_p{q}_ms": float(np.percentile(lat, q)) for q in (50, 90, 95, 99)},
            "latency_max_ms": float(lat.max())}
