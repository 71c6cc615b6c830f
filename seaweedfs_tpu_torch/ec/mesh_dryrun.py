"""A dry run of the sharded encode across processes.

``run()`` starts ``procs`` worker processes that form a ``torch.distributed``
group over ``tcp://127.0.0.1:<free port>`` and build one mesh over every
rank's ``devices`` (``sharded.build_process_mesh``): dp crosses the ranks,
sp and tp stay inside each. Each rank makes the same seeded batch
``uint8[procs * batch, k, width]``, encodes its own dp rows with
``make_sharded_encode(process_local=True)``, holds them against a
single-device codec's parity computed in the same rank, and the ranks'
rows are gathered on rank 0 (``dist.all_gather`` on host tensors: gloo's
CUDA support is partial). With ``out_dir`` rank 0 also writes the batch and
its parity as ``data.npy`` and ``parity.npy``.

The group is gloo, which also serves ranks that share one card (NCCL
refuses two ranks on one GPU). Each worker is this module run with the
worker's arguments (``main``); its output goes to a file, not a pipe, and a
rendezvous whose port was taken meanwhile is retried once on a new port.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VERDICT = "MESH-DRYRUN "


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _attempt(argv: list, procs: int, timeout: float) -> dict:
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    with tempfile.TemporaryDirectory() as logs:
        files = [open(os.path.join(logs, f"rank{r}.log"), "w+") for r in range(procs)]
        workers = [subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch.ec.mesh_dryrun",
             "--rank", str(r), "--port", str(port), *argv],
            env=env, cwd=REPO, stdout=files[r], stderr=subprocess.STDOUT, text=True)
            for r in range(procs)]

        def tail(r: int) -> str:
            files[r].flush()
            files[r].seek(0)
            return "\n".join(files[r].read().strip().splitlines()[-12:])

        deadline = time.monotonic() + timeout
        try:
            # one rank dying early leaves its peer in the rendezvous: report
            # the one that died, at once
            while any(w.poll() is None for w in workers):
                if time.monotonic() > deadline:
                    raise RuntimeError(f"mesh dry run timed out after {timeout} s:\n{tail(0)}")
                for r, w in enumerate(workers):
                    if w.poll() is not None and w.returncode != 0:
                        raise RuntimeError(f"mesh dry run rank {r} failed:\n{tail(r)}")
                time.sleep(0.05)
        finally:
            for w in workers:
                if w.poll() is None:
                    w.kill()
                w.wait()
        out = tail(0)
        for f in files:
            f.close()
    lines = [ln for ln in out.splitlines() if ln.startswith(VERDICT)]
    if not lines:
        raise RuntimeError(f"mesh dry run: no verdict from rank 0:\n{out}")
    return json.loads(lines[-1][len(VERDICT):])


def run(procs: int = 2, devices: Sequence[str] = ("cpu", "cpu"), tp: int = 2,
        batch: int = 2, width: int = 4096, seed: int = 0, out_dir: Optional[str] = None, timeout: float = 120.0) -> dict:
    """Run the dry run; returns rank 0's verdict: the mesh's shape, each
    rank's kernel launches, the bytes that differ from the single-device
    codec's (0 when right) and the seconds of the sharded encode."""
    argv = ["--procs", str(procs), "--devices", ",".join(devices), "--tp", str(tp),
            "--batch", str(batch), "--width", str(width), "--seed", str(seed),
            "--timeout", str(timeout)]
    if out_dir:
        argv += ["--out", out_dir]
    try:
        return _attempt(argv, procs, timeout)
    except RuntimeError as e:
        low = str(e).lower()
        # only the free-port race is retried: a real hang must not double
        if "address already in use" in low or "eaddrinuse" in low:
            return _attempt(argv, procs, timeout)
        raise


def _worker(a) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from . import gf_matmul as gm
    from .codec import get_codec
    from .sharded import build_process_mesh, init_mesh, make_sharded_encode

    torch.set_num_threads(1)
    init_mesh(f"127.0.0.1:{a.port}", a.procs, a.rank, "gloo", timeout=a.timeout)
    try:
        devices = a.devices.split(",")
        mesh = build_process_mesh(devices, tp=a.tp)
        dev = mesh.devices[0, 0, 0]
        ref = get_codec(device=str(dev))
        k = ref.data_shards
        B = a.procs * a.batch
        gen = torch.Generator(device=dev).manual_seed(a.seed)
        data = torch.empty((B, k, a.width), dtype=torch.uint8, device=dev).random_(
            0, 256, generator=gen)
        enc = make_sharded_encode(mesh, ref.parity_rows, process_local=True)
        # this rank's rows: its dp slices, in order
        dp = mesh.shape["dp"]
        mine = [i for i in range(dp) if int(mesh.processes[i].flat[0]) == a.rank]
        per = B // dp
        rows = torch.cat([data[i * per:(i + 1) * per] for i in mine])
        enc(rows[:len(mine)])  # first use: kernel build and masks, untimed
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        l0 = gm.gf_matmul.launches
        t0 = time.perf_counter()
        parity = enc(rows)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        launches = gm.gf_matmul.launches - l0
        want = torch.stack([ref.matmul_device(ref.parity_rows, rows[b]) for b in range(len(rows))])
        bad = int((want != parity).sum())
        got = [torch.empty_like(parity, device="cpu") for _ in range(a.procs)]
        dist.all_gather(got, parity.cpu())
        stats: list = [None] * a.procs
        dist.all_gather_object(stats, {"rank": a.rank, "launches": launches,
                                       "mismatches": bad, "seconds": seconds,
                                       "dp_slices": mine})
        if a.rank == 0:
            if a.out:
                np.save(os.path.join(a.out, "data.npy"), data.cpu().numpy())
                np.save(os.path.join(a.out, "parity.npy"), torch.cat(got).numpy())
            print(VERDICT + json.dumps({
                "world": a.procs, "mesh": mesh.shape, "devices": devices,
                "shape": [B, k, a.width],
                "launches": [s["launches"] for s in stats],
                "mismatches": sum(s["mismatches"] for s in stats),
                "seconds": [s["seconds"] for s in stats],
                "dp_slices": [s["dp_slices"] for s in stats]}), flush=True)
    finally:
        dist.destroy_process_group()


def main(argv: Optional[list] = None) -> int:
    """One worker rank, with the arguments ``run()`` gives it."""
    p = argparse.ArgumentParser(description="one rank of mesh_dryrun.run()")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--procs", type=int, required=True)
    p.add_argument("--devices", required=True)
    p.add_argument("--tp", type=int, required=True)
    p.add_argument("--batch", type=int, required=True)
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--timeout", type=float, required=True)
    p.add_argument("--out", default="")
    _worker(p.parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
