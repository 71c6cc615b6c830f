"""Seal and rebuild one volume in fixed slots (``ec.encode``, ``ec.rebuild``).

Set-up: the master and one volume server; a volume filled with the mix's
needles in order over one connection (fids made here), so that the plain
reference can lay out the same .dat; one warm-up cycle (judged, not timed). The window: one
cycle in each of the traffic's slots (``clients.seal_cycles``).

``seal_rebuild_wall_GBps`` is the .dat bytes of the window's cycles over
their summed round trips (generate, delete, rebuild), the time an operator
waits for the seal and for the rebuild of what was lost: the host's clock,
read per layer. ``seal_rebuild_device_GBps``
(``swbench/end_to_end/seal_rebuild_device_GBps.py``) puts the same cycles'
stripes over the card's busy time: the .dat through the card once for each
generate and once for each rebuild (``work["seal_rebuild_bytes"]``). Each
generate's and each rebuild's round trip, the generates' rate alone and the
host rate are in the result's ``detail``.

Correct: every shard file after every generate, and every rebuilt one after
every rebuild, hashes as the plain reference's shard of the same .dat
(``reference.rs`` over ``reference.needle``). Each record's two time
fields are the only bytes taken from the judged volume (read from its
final data shards): no seed fixes a clock.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from swbench.cluster import admin
from swbench.gen.needles import Needles
from swbench.reference import needle as ref_needle
from swbench.reference import rs

VID = 1


def _needles(ctx) -> dict:
    m = ctx.config["needles"]
    return {"seed": ctx.seed, "fill": ctx.traffic["volume_bytes"], "lo": m["min_bytes"],
            "hi": m["max_bytes"]}


def setup(ctx, cluster) -> dict:
    cluster.start_master()
    (url,) = cluster.start_volume_servers(1)
    admin(url, f"/admin/assign_volume?volume={VID}&replication="
               f"{ctx.config['guarantees']['replication']}")
    statuses = cluster.worker("upload_direct", url=url, vid=VID,
                              needles=_needles(ctx)).result()
    if any(s != 201 for s in statuses):
        raise RuntimeError(f"uploads failed: {sorted(set(statuses))}")
    vs = cluster.servers[url]
    base = vs.store.find_volume(VID).file_name()
    if ctx.control:
        from swbench.control import xor_codec

        xor_codec(vs.store.ec_codec)
    if ctx.inject:
        ctx.inject(ctx, cluster)
    lost = ctx.traffic["lost_shards"]
    cycles = cluster.worker("seal_cycles", url=url, vid=VID, base=base, lost=lost,
                            slots=ctx.traffic["slots"])
    return {"url": url, "base": base, "worker": cycles, "lost": lost,
            "warmup": cycles.ready()["warmup"]}


def window(ctx, state) -> dict:
    t0, t1 = ctx.begin_window()
    state["worker"].go(t0, t1)
    got = state["worker"].result(timeout=ctx.seconds + 600)
    ctx.end_window(got["done"])
    return got


def finish(ctx, state, got) -> object:
    from swbench.harness import Outcome

    cycles = got["cycles"]
    steps = [s for c in cycles for s in c["steps"]]
    failed = sum(s[3] != 200 for s in steps)
    gens = [c["generate"] for c in cycles if "bytes" in c["generate"]]
    gen_s = sum(s[2] - s[1] for s in steps if s[0] == "generate")
    cycle_s = sum(s[2] - s[1] for s in steps)
    reb = [s[2] - s[1] for s in steps if s[0] == "rebuild"]
    want = _reference_sums(ctx, state)
    wrong = 0
    for c in cycles + [state["warmup"]]:  # the warm-up's shards are judged too
        wrong += sum(a != b for a, b in zip(c["after_generate"], want))
        wrong += sum(c["after_rebuild"][i] != want[i] for i in state["lost"])
    dat_bytes = sum(g["bytes"] for g in gens)
    shard_bytes = rs.shard_size(gens[0]["bytes"]) if gens else 0
    wall = dat_bytes / cycle_s / 1e9 if cycle_s else 0.0
    return Outcome(
        metrics={"seal_rebuild_wall_GBps": wall},
        attempted=len(steps), failed=failed,
        checks={"shard_files_wrong": (wrong, 0), "admin_calls_failed": (failed, 0)},
        work={"ec_kernel_bytes": rs.TOTAL_SHARDS * shard_bytes * (len(gens) + len(reb)),
              "seal_rebuild_bytes": dat_bytes + (gens[0]["bytes"] * len(reb) if gens else 0),
              "generates": len(gens), "rebuilds": len(reb)},
        detail={"seal_rebuild_wall_GBps": wall, "cycles": len(cycles), "generate_s": [s[2] - s[1] for s in steps
                                                      if s[0] == "generate"],
                "rebuild_s": reb, "seal_GBps": dat_bytes / gen_s / 1e9 if gen_s else 0.0,
                "late_s": [c["steps"][0][1] - c["slot"] for c in cycles],
                "dat_bytes": gens[0]["bytes"] if gens else 0})


def _reference_sums(ctx, state) -> list:
    """sha256 of each of the 14 shards the reference makes of the volume."""
    ns = Needles(**_needles(ctx))
    dat_len = ref_needle.SUPER_BLOCK + sum(ref_needle.record_length(n) for n in ns.lens)
    judged = rs.unstripe(_data_shards(state["base"], rs.shard_size(dat_len)), dat_len)
    times = [(int.from_bytes(judged[a:a + ref_needle.LAST_MODIFIED], "big"),
              int.from_bytes(judged[b:b + ref_needle.TIMESTAMP], "big"))
             for a, b in ref_needle.time_fields(ns.lens)]
    dat = ref_needle.volume(
        [(ns.cookie(i), ns.key(i), ns.payload(i)) for i in range(len(ns))], times,
        ctx.config["guarantees"]["replication"])
    return [hashlib.sha256(s.tobytes()).hexdigest() for s in rs.encode_dat(dat)]


def _data_shards(base: str, size: int) -> np.ndarray:
    out = np.zeros((rs.DATA_SHARDS, size), dtype=np.uint8)
    for i in range(rs.DATA_SHARDS):
        path = f"{base}.ec{i:02d}"
        if os.path.exists(path):
            got = np.fromfile(path, dtype=np.uint8)[:size]
            out[i, :len(got)] = got
    return out
