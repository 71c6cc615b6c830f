"""S3-Select pushdown: ``/_query`` requests over CSV objects from query streams.

Set-up: the master and one volume server; the objects made from the seed
by worker processes and POSTed, one needle each (fids made here); one
warm-up query from each stream. The window: one closed-loop window of the
traffic's ``streams`` (``swbench/loads.py``), each request TPC-H Q6 on an
object its stream picks uniformly from the seed; a request's stored bytes
are its object's.

Correct: every query answered, in the window or after it, returns the rows
the plain reference's Q6 filter selects from its object (``reference.q6``,
over the object made again from the seed), compared by row count and by a
digest of the rows' text in order.
"""

from __future__ import annotations

import numpy as np

from swbench import loads
from swbench.cluster import admin
from swbench.gen.needles import fid
from swbench.reference import q6

VID = 1


def _cookies(ctx) -> list:
    rng = np.random.default_rng([ctx.seed, 4])
    return [int(c) for c in rng.integers(1, 1 << 32, ctx.traffic["objects"])]


def _split(n: int, parts: int) -> list:
    return [list(range(n))[i::parts] for i in range(parts)]


def setup(ctx, cluster) -> dict:
    t = ctx.traffic
    cluster.start_master()
    (url,) = cluster.start_volume_servers(1)
    admin(url, f"/admin/assign_volume?volume={VID}&replication="
               f"{ctx.config['guarantees']['replication']}")
    cookies = _cookies(ctx)
    ups = [cluster.worker("upload_objects", url=url, vid=VID, seed=ctx.seed, indices=part,
                          size=t["object_bytes"], cookies=[cookies[i] for i in part])
           for part in _split(t["objects"], t["make_workers"])]
    sizes = {}
    for w in ups:
        for i, status, n in w.result():
            if status != 201:
                raise RuntimeError(f"object {i}: POST answered {status}")
            sizes[i] = n
    if ctx.control:
        from swbench.control import float32_q6
        from seaweedfs_tpu_torch.server import volume_server

        float32_q6(volume_server, t["query"])
    if ctx.inject:
        ctx.inject(ctx, cluster)
    fids = [fid(VID, i + 1, cookies[i]) for i in range(t["objects"])]
    worker, warm = loads.start(ctx, cluster, "query", {"fids": fids, "sql": q6.sql(t["query"])},
                               [url], t["objects"])
    return {"worker": worker, "warm": warm, "sizes": sizes, "cluster": cluster}


def window(ctx, state) -> list:
    return loads.window(ctx, state["worker"])


def finish(ctx, state, recs) -> object:
    from swbench.harness import Outcome

    ref = _reference(ctx, state)
    judged = recs + state["warm"]  # the warm-up's answers are judged too
    wrong = sum(r[3] != 200 or (r[4], r[5]) != ref[r[0]] for r in judged)
    m = loads.reduce(recs, ctx.window, lambda r: state["sizes"][r[0]])
    done = [r for r in recs if r[3] == 200 and r[2] <= ctx.window[1]]
    return Outcome(
        metrics=m, attempted=len(recs), failed=sum(r[3] != 200 for r in recs),
        checks={"replies_wrong": (wrong, 0)},
        work={**m, "query_bytes_scanned": sum(state["sizes"][r[0]] for r in done)},
        detail={k: v for k, v in m.items() if k != "read_MBps"})


def _reference(ctx, state) -> dict:
    """object -> (rows, digest) of the plain filter, made in worker
    processes from the seed."""
    t = ctx.traffic
    ws = [state["cluster"].worker("q6_reference", seed=ctx.seed, indices=part,
                                  size=t["object_bytes"], params=t["query"], narrow=False)
          for part in _split(t["objects"], t["make_workers"])]
    out = {}
    for w in ws:
        for i, n, d in w.result():
            out[i] = (n, d)
    return out
