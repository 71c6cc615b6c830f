#!/usr/bin/env python3
"""Drive the PyTorch port's erasure-coding, query, cluster, filer, S3, mesh,
filer-fleet, client-gateway and operator-tool paths on one NVIDIA GPU, the
last under the lock-order and race sanitizers.

    python3 chip_smoke.py

Builds the GF(2^8) kernel from ``seaweedfs_tpu_torch/csrc`` and runs:

0. environment: card name and power limit (nvidia-smi), torch/CUDA
   versions, kernel build time, ptxas's registers and spills, and a SASS
   summary of the RS(10,4) instantiation (cuobjdump);
1. kernel vs plain PyTorch version on the card, (R, k) in
   {(4,10), (1,10), (2,10), (3,10), (3,6), (4,12), (8,10), (16,10), (4,16),
   (4,17), (64,64), (4,1)} x widths {1, 15, 16, 17, 65537, 32 MiB}, plus
   strided and unaligned layouts, and at widths 17 and 65537 the
   ``accumulate`` form (XOR into the output) — byte-equal or fail; the kernel's time at
   the encode shape beside its bound and the plain version's time;
2. device-resident RS(10,4) encode of one default-size 30 GB volume (data
   uint8[10, 3 GiB] made on the card from a seed) through
   CudaCodec.matmul_device, every parity byte checked against the plain
   version;
3. device-resident rebuild of 4 lost shards {0, 3, 10, 13} of that volume,
   chunk by chunk through one composite matrix, checked against the
   originals; the per-chunk stacking of the 10 survivors and the kernels
   are timed apart;
4. file-level encode (storage.store.ec_encode_volume) and 4-shard rebuild
   (rebuild_ec_files) of a 1 GiB .dat, checked against the striped .dat,
   the plain version and the .vif sha256 sums;
5. a small-needle volume: degraded reads of every needle with a data shard
   lost (read_ec_shard_needle), then decode_to_volume with three data
   shards lost, checked byte for byte against what was written;
6. the server path: a port VolumeServer (CUDA backend) beside the port's
   MasterServer takes 1 GiB of needles (1 KiB-1 MiB, log-uniform) over HTTP
   from 8 threads; /admin/ec/generate (shards checked as in phase 4), mount,
   delete_volume, delete_shards {0, 3, 10, 13}, 64 degraded GETs compared
   byte for byte, /admin/ec/rebuild (sha256 against the .vif), then
   /admin/ec/to_volume with data shards 1, 2, 5 lost (.dat identical, .idx
   identical in key order). Each EC step must launch the kernel, and the
   needle CRC must be the native build;
7. the query path: a port VolumeServer (CUDA backend) beside the port's
   master holds four 32 MiB CSV needles (``id,region,score,name``, the
   query probe's schema, from a seed; the last, needle 3, with 1 %
   1e3-style scores and 1 % non-ASCII names). Six /_query requests per needle (the probe's
   ``region = 'east' AND score > 995``, contains, starts_with, a
   lexicographic ``<``, ``NOT ... OR ...``, ``LIMIT``) run the scan's
   predicate tree on the card; every reply must equal the cpu backend's
   rows, and on the first 4 MiB of needle 3 the row-at-a-time engine's.
   The numeric parse on the card must equal float() on an edge corpus.
   Latency p50/p99 and MB/s per query, the kernel/exact-lane split, peak
   device memory, one query's time split into its steps and the kernels per
   tree evaluation (torch.profiler). Then the port shell's ``ec.encode
   -fleet`` encodes the volume through the master's fleet scheduler, the
   shard holding needle 3's first block is deleted, and the probe query on
   needle 3 must return the same rows, through gf_matmul;
8. the cluster path: the port's master, four port volume servers (CUDA
   backend) and the port shell. A volume grown in a collection of its own
   is filled to 512 MiB from 8 threads, every fid from /dir/assign;
   ``ec.encode`` generates on the card and spreads the shards 4/4/3/3; the
   server with shards 1, 5, 9, 13 stops and the master's reaper drops it;
   64 degraded GETs and 64 healthy remote GETs go through /dir/lookup;
   ``ec.rebuild`` copies survivors in and rebuilds the 4 lost shards on the
   card; the server with shards 3, 7, 11 stops too and ``ec.decode``
   rebuilds data shards 3 and 7 in to_volume; a seeded 1 024 needles read
   back equal and the decoded .dat hashes as the original. Each EC step (encode,
   degraded GETs, rebuild, decode) must launch the kernel;
9. an operator's maintenance cycle: the port's master, four port volume
   servers (CUDA backend) with the background scrub on (``SWEED_SCRUB=1``,
   ``SWEED_SCRUB_RATE`` raised to 1024) and the port shell. A 512 MiB volume
   (phase 8's needles) loses ~30 % of its needles; ``volume.vacuum``
   compacts it while a writer and a deleter keep at it (every write and
   delete must survive, the compaction revision must reach the master);
   ``volume.configure.replication`` and ``volume.fix.replication`` copy it
   to a second server; a byte flipped in that copy reaches the master as a
   corrupt needle through the scrub, the copy is dropped and fixed again;
   ``volume.move`` and ``volume.balance`` move replicas; ``backup`` copies
   it (full, then incremental, byte for byte); ``ec.encode`` seals it on the
   card (shards checked against the plain version); a byte flipped in a
   shard reaches the master as a corrupt shard, the shard is dropped and
   ``ec.rebuild`` makes it again on the card (sha256 equal to the .vif's);
   ``volumeServer.evacuate`` and ``volumeServer.leave`` retire a server, which
   the master drops at once; a seeded 1 024 needles (live ones equal,
   deleted ones 404) read back through the master. ``ec.encode`` and
   ``ec.rebuild`` must launch the kernel;
10. ``weed benchmark`` on the default data plane: the port's master and one
   port volume server on ``weed master``/``weed volume`` defaults (CUDA
   backend, the native turbo engine on the public port, the asyncio core
   behind it). ``run_benchmark`` at `weed/command/benchmark.go`'s defaults
   but an eighth of its files (131 072 files of 1 KiB from 16 connections, assigns
   in batches of 100): no failure, a seeded 4 096 fids read back equal, the
   engine's native posts and gets covering the run and its proxied requests
   a sliver of it. The same server restarted with ``SWEED_TURBO=0`` (the
   asyncio core alone): a 4 096-file run, 64 GETs of 256 KiB needles by
   sendfile (byte-equal, served natively on the loop), then 512 concurrent
   connections against ``SWEED_MAX_INFLIGHT=64``: every reply a 200 or a 503
   with ``Retry-After``, at least one 503, then 64 GETs all 200. The engine
   on again: the shell's ``ec.encode`` seals the fullest benchmark volume on
   the card (shards checked against the plain version), shards {0, 3, 10,
   13} go, and a seeded sample of its fids reads back equal through the
   engine's public port, which proxies EC reads to Python and so to the
   kernel. The encode and the reads must launch the kernel;
11. the master's autopilot, with no operator command after setup: three port
   masters (``master -peers A,B,C -mdir D`` subprocesses, ``SWEED_LIFECYCLE=1``
   at a cycle a second, the cold tier at the in-repo fake S3) and four port
   volume servers (CUDA backend, the scrub on, the Python data plane: the
   engine marks no heat). A 256 MiB volume with 40 % of its needles deleted
   is vacuumed; a 256 MiB volume read once a second cools and is fleet-EC'd
   on the card, the first leader dying (``lifecycle.journal.running=crash``)
   as that EC starts and a follower, elected, running it once (one generate);
   a byte flipped in one of its shards reaches the leader through the scrub
   and ``repair_shard`` rebuilds it on the card (sha256 equal to the .vif's);
   a 128 MiB volume never read moves to the tier, 64 reads through the tier
   warm it and it comes back; the dead master restarts from its ``-mdir``,
   the leader stops, and the restarted one, elected, replays its journal
   without running the EC again; a seeded 1 024 live needles read back
   through the masters. Prints each action's seconds from its plan to done, the
   failover's seconds, the tier's MB/s both ways and its GET p50/p99.
12. the filer path: the port's master, four port volume servers (CUDA
   backend, the engine on) and one port filer (``weed filer`` defaults: 32
   MiB chunks, a sqlite ``filer.db``, replication 000, four uploads and four
   chunk fetches in flight) with a collection of its own on four volumes.
   From 8 threads: 1 024 small files (1 KiB-1 MiB) under 16 directories,
   two 64 MiB streaming PUTs, one 64 MiB ``?cipher=true`` object, CSV
   objects of phase 7's schema (three of 32 MiB, one of 96 MiB in three
   chunks, one gzip'd). Every directory listed page by page, every file read
   back, 32 ranged GETs, a directory renamed and another deleted (its
   chunks purged on the volume servers). Phase 7's six queries through the
   filer's ``/_query``: pushed down to the volume server holding each
   single-chunk CSV (its own scan count must grow by one a query), scanned
   on the filer's card for the 3-chunk one; the probe as ``/_select``
   (event-stream CRCs checked) on the 3-chunk and gzip'd objects; every
   reply equal to the cpu backend's. Then ``ec.encode`` seals every volume
   of the collection (4/4/3/3), the server with shards 1, 5, 9, 13 of the
   first stops, a seeded 256 of the small files and the cipher'd object
   read back through the filer and the probe runs again on two sealed CSVs. The seal and the degraded reads
   must launch the kernel.
13. the S3 gateway: the port's master, four port volume servers (CUDA
   backend, the engine on), one port filer (``weed filer`` defaults) and the
   port's gateway (``weed s3`` defaults, an ``s3.json`` of two identities:
   full access, and read and list of one bucket). Through the port's
   ``S3Client`` with SigV4, from 8 threads: 512 objects (1 KiB-1 MiB), a 64
   MiB multipart upload of 8 MiB parts whose last part is an
   UploadPartCopy, a 64 MiB aws-chunked streaming upload, phase 12's schema
   as CSVs of 32 and 96 MiB. ListObjectsV2 by pages of 100, every object
   read back, 32 ranged GETs, a presigned GET, a POST-policy upload; the
   read-only identity's PUT (403 AccessDenied) and a bad signature (403
   SignatureDoesNotMatch) refused; SelectObjectContent with the probe on
   both CSVs equal to the cpu backend's rows. Then ``ec.encode`` seals the
   volumes, the server with shards 1, 5, 9, 13 of the first stops, and a
   seeded 64 of the small objects read back equal and the sealed 32 MiB
   CSV's Select gives the same rows, through the kernel; that Select's
   trace id leads, through the daemons' ``/debug/traces`` and
   ``/_debug/traces``, to one tree of the gateway's, the filer's and a
   volume server's spans. The seal, the degraded reads and the sealed
   Select must launch the kernel.
14. the multi-device codec (``ec/sharded.py``) and mesh members, on the one
   card: a. phase 2's geometry through ``MeshCodec.matmul_device`` on the
   (2,2,1) and (2,1,2) meshes over ``[cuda:0] * 4``, equal to CudaCodec's
   parity (``torch.equal``), with both times; b. a 1 GiB .dat through
   ``write_ec_files`` and ``rebuild_ec_files`` ({0, 3, 10, 13} lost) on the
   tp=2 mesh, every shard's sha256 equal to CudaCodec's files'; c. a Store
   whose codec is that mesh reads 40 needles of 200-400 KB back with shards
   {0, 4, 9, 12} lost and no remote reader; d. two ranks over gloo share the
   card (``ec/mesh_dryrun.py``): ``make_sharded_encode(process_local=True)``
   with dp across the ranks and tp=2 in each, equal to CudaCodec's parity in
   the same rank, each rank's launches reported and added to the count;
   e. the port's master and two volume servers that are single-process mesh
   members (``SWEED_MESH=1``, ``-ec.backend mesh``, the Python data plane),
   one on ``-index sqlite`` and one on ``-index mmap``, 256 MiB of phase 8's
   needle mix each; ``/ec/fleet/status`` lists both, ``ec.encode -fleet``
   seals each volume on its member, a seeded 512 needles of each read back; the sqlite
   server restarts on ``-index sorted`` over a sealed plain volume and every
   needle of it reads back. Each step must launch the kernel.
15. the filer fleet: the port's master, four port volume servers (CUDA
   backend, the engine on), three port filers as one ring (``ring_peers``,
   the default shard depth 2, 32 MiB chunks; stores sqlite, redis over an
   in-process ``MiniRedisServer`` and ``GenericSqlStore("sqlite3")``; the
   first publishing its meta events to a file queue), the port's gateway
   over ``-filer A,B,C`` and a fourth filer outside the ring as the
   ``filer.sync`` target. a. ``RingFilerClient`` writes 1 024 files of
   phase 6's mix under 16 shard roots ``/b15/dNN`` from 8 threads, and
   phase 7's schema as 32, 32 and 96 MiB CSVs in buckets owned by three
   members; b. a plain ``FilerClient`` on one member follows 64 307s,
   has 64 POSTs proxied, and lists the spine ``/b15`` merged across the
   members, whose shares add up to every file; c. 128 S3 objects PUT, GET
   and listed by 100, and the probe's SelectObjectContent on a 32 and the
   96 MiB CSV, each scanned on the card by its owner filer, rows equal to
   the cpu backend's; d. ``/_reshard`` moves the largest shard root to
   another member (``tree_hash`` equal, no source entry, no marker left,
   every file read back); e. ``FilerSync`` drains the first member's share
   into the fifth filer, byte for byte, then one write's lag; the file
   queue holds one event per mutation; f. ``ec.encode`` seals the
   collection (4/4/3/3), the server with shards 1, 5, 9, 13 stops, and a
   seeded 64 files read back through the ring and the sealed 32 MiB CSV's
   Select, through the kernel. The seal, the degraded reads and the sealed
   Select must launch the kernel.
16. the filer's client gateways: the port's master, four port volume servers
   (CUDA backend, the engine on), one port filer (``weed filer`` defaults,
   collection ``gw16``) and over it the port's WebDAV gateway, FTP gateway
   and message broker. a. WebDAV from 8 threads: 256 PUTs of 1 KiB-1 MiB, a
   streamed 64 MiB PUT, every file read back, PROPFIND, LOCK/PUT/UNLOCK,
   MOVE and COPY of a collection; b. FTP (``ftplib``, passive): 128 STORs
   and a 64 MiB one, LIST, every file RETR'd; c. a port ``WFS`` writes a 64
   MiB file by random writes (read-your-writes before the flush), reads it
   back and renames it; ``filer.copy`` of 128 files (the function and the
   CLI); one ``MountSync`` round both ways; and where the host has FUSE the
   kernel mount (``cp``, ``cat``, ``ls``; else the line says why not);
   d. 8 000 messages published through the broker from 4 threads, every
   partition replayed from 0 in order, count and md5 equal; e. ``ec.encode``
   seals the collection (4/4/3/3), the server with shards 1, 5, 9, 13 of the
   first stops, and a seeded 32 files read back through WebDAV and 32
   through FTP, the 64 MiB file through WFS (and the small files through
   FUSE), and a whole
   partition through a restarted broker, byte for byte. The seal and the
   sealed reads (together) must launch the kernel.

17. the operator's tools: ``python -m seaweedfs_tpu_torch -cpuprofile=P server
   -dir D -max 14 -filer -s3 -webdav`` as a subprocess (CUDA backend, ports
   from ``util/netports``). a. the stack comes up; b. from 8 threads
   through its filer 1 024 files of phase 6's sizes (printable text) under
   16 directories, a 32 MiB CSV of phase 7's schema, and 16 orphan needles
   (``/dir/assign`` and a POST, no filer entry); c. ``shell -master M
   -filer F -c ...``: ``fs.cd/pwd/ls/du/tree/cat/mv``, ``fs.meta.cat``,
   ``fs.meta.save``, ``fs.configure`` (a write under the prefix lands in
   its collection), ``bucket.create/list/delete`` (seen through the S3
   port), ``volume.fsck`` (exactly the 16 orphans; ``-apply`` purges none
   inside its 300 s cutoff); d. the stand-alone ``ec.encode`` of the CSV's
   volume, the shell's ``ec.encode`` of the filer's volumes but one,
   shards {1, 5, 9, 13} lost on the CSV's volume and on the fullest small
   files' volume, 64 ``fs.cat``s of that volume's files in one shell
   session (bytes equal), the probe by ``query`` (rows equal to the cpu
   backend's) and ``trace`` of it; e. SIGTERM (the cpu profile loads with
   ``pstats``), then on the data directory ``dump.idx -ext .ecx``,
   ``dump.dat``, ``export``, ``fix`` (the .idx equal), ``change.superblock``,
   ``scaffold`` and ``version``. The server's launches (its ``/status``)
   count; the seal and the sealed reads must launch the kernel.
18. the sanitizers on the card: ``python -m seaweedfs_tpu_torch server -dir D
   -max 7 -filer`` as a subprocess under ``SWEED_LOCK_CHECK=1`` and
   ``SWEED_RACE_CHECK=1`` with their dumps (CUDA backend, the engine on),
   while this process computes the port analyzer's static lock graph and
   race candidates over ``seaweedfs_tpu_torch/``. 256 files of phase 6's
   mix through its filer from 8 threads, the shell's ``ec.encode`` of the
   filer's volumes, shards {1, 5, 9, 13} dropped on the fullest, a seeded
   64 of its files read back through the filer from 8 threads (byte for
   byte); the lock counters in ``/dir/status`` and ``/_status`` non-zero
   and the four ``sweed_lock_*`` gauges in ``/metrics``; SIGTERM. No
   ``LockOrderError``, a clean exit, acquisitions and edges recorded, every
   observed edge in the static graph and every race observation among the
   static candidates. Prints the counters, the edges beyond those the CPU
   cross-checks saw, and the fill's MB/s with both sanitizers on. The seal
   and the sealed reads must launch the kernel.

Phases 6, 8, 9, 10, 12, 13, 15 and 16 run with the JAX package's default serving stack: the
native turbo engine (built from ``seaweedfs_tpu_torch/csrc/turbo.cpp``)
owns each volume server's public port, the asyncio core serves the rest.
Each of them fails if a volume server in it started without the engine, and
prints the engines' counters (native gets, posts, deletes; proxied
requests).

Phase 1 also runs four CudaCodecs from four threads at once (the volume
servers of phase 8 share the card so, and the fleet scheduler runs up to
four generate jobs together); each result must equal the plain version's.

Every phase prints one JSON line with its numbers and kernel launches.
Phases 2-18 are the main path: the launch counts are zeroed before phase 2
and read after phase 18 (phase 14's child ranks and phase 17's and 18's
servers count in their own processes and report theirs), and every phase must have
launched the kernel. The
line before last lists each kernel with its launches, error and times; the
last line is the device record. Any mismatch or error exits non-zero.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import gzip
import hashlib
import http.client
import io
import json
import os
import re
import resource
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tarfile
import threading
import time
import urllib.parse

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from seaweedfs_tpu_torch.__main__ import run_benchmark  # noqa: E402
from seaweedfs_tpu_torch.ec import decoder, encoder  # noqa: E402
from seaweedfs_tpu_torch.ec import gf_matmul as gm  # noqa: E402
from seaweedfs_tpu_torch.ec import mesh_dryrun  # noqa: E402
from seaweedfs_tpu_torch.ec.codec import get_codec  # noqa: E402
from seaweedfs_tpu_torch.ec.constants import shard_ext  # noqa: E402
from seaweedfs_tpu_torch.ec.decoder import decode_to_volume  # noqa: E402
from seaweedfs_tpu_torch.ec.ec_volume import EcVolume  # noqa: E402
from seaweedfs_tpu_torch.ec.sharded import MeshCodec  # noqa: E402
from seaweedfs_tpu_torch.query import execute_request, parse_sql, run_query  # noqa: E402
from seaweedfs_tpu_torch.query import scan as query_scan  # noqa: E402
from seaweedfs_tpu_torch.query import select as s3select  # noqa: E402
from seaweedfs_tpu_torch.query.scan import TorchKernels, compile_plan  # noqa: E402
from seaweedfs_tpu_torch.server.filer_server import FilerServer  # noqa: E402
from seaweedfs_tpu_torch.server.http_util import SERVING  # noqa: E402
from seaweedfs_tpu_torch.server.master_server import MasterServer  # noqa: E402
from seaweedfs_tpu_torch.server.volume_server import VolumeServer  # noqa: E402
from seaweedfs_tpu_torch.shell import commands as shell_commands  # noqa: E402
from seaweedfs_tpu_torch.shell.commands import CommandEnv  # noqa: E402
from seaweedfs_tpu_torch.shell.shell import run_command  # noqa: E402
from seaweedfs_tpu_torch.stats.metrics import QUERY_COUNTERS, SCRUB_COUNTERS  # noqa: E402
from seaweedfs_tpu_torch.storage import crc  # noqa: E402
from seaweedfs_tpu_torch.storage import idx as idx_mod  # noqa: E402
from seaweedfs_tpu_torch.storage.file_id import FileId  # noqa: E402
from seaweedfs_tpu_torch.storage.needle import Needle, get_actual_size  # noqa: E402
from seaweedfs_tpu_torch.storage.needle_map import IdxLogMixin  # noqa: E402
from seaweedfs_tpu_torch.storage.store import (  # noqa: E402
    Store,
    ec_encode_volume,
    read_ec_shard_needle,
)
from seaweedfs_tpu_torch.storage.backend.fake_s3 import FakeS3Server  # noqa: E402
from seaweedfs_tpu_torch.storage.super_block import SuperBlock  # noqa: E402
from seaweedfs_tpu_torch.storage.volume import Volume, volume_file_name  # noqa: E402

MiB, GiB = 1 << 20, 1 << 30
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
INT8_OPS_PER_S = 1.979e15  # H100 SXM dense int8 tensor-core rate
LOST = [0, 3, 10, 13]  # two data + two parity shards
WORK = os.path.join(HERE, "chip_smoke_work")
EC_BACKEND = "cuda"  # the volume servers' codec in phases 6-9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int, reps: int = 1) -> list[float]:
    """Per-call device time of ``fn`` with CUDA events on the current stream:
    each run times ``reps`` calls back to back, so the host's time to enqueue
    one call hides behind the device's work on the one before."""
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return times


def gf_bound_ms(R: int, k: int, n: int) -> tuple[float, str]:
    """Least time for out[R, n] = M[R, k] (x) data[k, n] on an H100 SXM: the
    bytes (each input read once, the output written once) over the memory
    rate, against the int8 tensor-core form's operations (the TPU kernel's
    bit-plane product, 2 * 8R * 8k per column) over the int8 peak."""
    bytes_ms = (k + R) * n / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * 8 * R * 8 * k * n / INT8_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def rand_u8(shape, gen) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.uint8, device="cuda").random_(0, 256, generator=gen)


def compare(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int]:
    """(mismatched bytes, max |a - b|)."""
    diff = (a.int() - b.int()).abs()
    return int((diff != 0).sum()), int(diff.max()) if diff.numel() else 0


_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_summary(lib: str, kc: int = 10) -> dict:
    """Opcode counts of gf_matmul_kernel<kc> in the built library, and of its
    output-row loop (the span of its longest backward branch), with how many
    of the loop's instructions are predicated on a vector or a uniform
    predicate."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    body = next(b for b in re.split(r"\n\s*Function : ", text)
                if re.match(rf"\S*gf_matmul_kernelILi{kc}E", b))
    insns = [(int(a, 16), p.strip().lstrip("@!"), op.split(".")[0], rest)
             for a, p, op, rest in _SASS_INSN.findall(body)]
    loop = (0, 0)  # (target, address) of the longest backward branch
    for addr, _, op, rest in insns:
        m = re.search(r"0x([0-9a-f]+)", rest)
        target = int(m.group(1), 16) if op == "BRA" and m else addr
        if addr - target > loop[1] - loop[0]:
            loop = (target, addr)
    in_loop = [i for i in insns if loop[0] <= i[0] <= loop[1]]
    return {"kernel": f"gf_matmul_kernel<{kc}>", "function_insns": len(insns),
            "loop_insns": len(in_loop),
            "loop_ops": dict(collections.Counter(i[2] for i in in_loop).most_common()),
            "loop_vector_predicated": sum(i[1].startswith("P") for i in in_loop),
            "loop_uniform_predicated": sum(i[1].startswith("UP") for i in in_loop)}


# -- phases ------------------------------------------------------------------
def phase0(state) -> None:
    t0 = time.perf_counter()
    lib = gm.build(verbose=True)  # prints ptxas's registers and spills
    build_s = time.perf_counter() - t0
    state["smi"] = smi_line()
    print(state["smi"], flush=True)
    emit({"phase": 0, "nvidia_smi": state["smi"], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "kernel_library": os.path.relpath(lib, HERE), "build_s": build_s,
          "sass": sass_summary(lib)})


def phase1(state) -> None:
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = mismatches = max_err = 0
    # R > 4, k at and past the kernel's 16-row chunk, and k = 1 beside the
    # shapes of the main path
    rng = np.random.default_rng(1)
    for R, k in [(4, 10), (1, 10), (2, 10), (3, 10), (3, 6), (4, 12),
                 (8, 10), (16, 10), (4, 16), (4, 17), (64, 64), (4, 1)]:
        matrix = rng.integers(0, 256, (R, k), dtype=np.uint8)
        for n in (1, 15, 16, 17, 65537, 32 * MiB):
            data = rand_u8((k, n), gen)
            layouts = [(data, None)]
            if n == 65537:
                # a column slice of a wider matrix at an odd offset (byte
                # path), written into a strided slice of a wider output
                wide = rand_u8((k, n + 21), gen)
                outw = torch.zeros((R, n + 5), dtype=torch.uint8, device="cuda")
                layouts.append((wide[:, 3:3 + n], outw[:, 2:2 + n]))
            for d, out in layouts:
                got = gm.gf_matmul(matrix, d, out=out)
                torch.cuda.synchronize()
                want = gm.gf_matmul_plain(matrix, d)
                bad, err = compare(got, want)
                if n in (17, 65537):
                    # accumulate (the mesh codec's tp combine): out ^= M (x) d
                    acc = rand_u8((R, n), gen)
                    want_acc = acc ^ want
                    gm.gf_matmul(matrix, d, out=acc, accumulate=True)
                    torch.cuda.synchronize()
                    b2, e2 = compare(acc, want_acc)
                    bad, err = bad + b2, max(err, e2)
                cases += 1
                mismatches += bad
                max_err = max(max_err, err)
                if bad:
                    print(f"MISMATCH R={R} k={k} n={n}: {bad} bytes", file=sys.stderr)
            del data
    torch.cuda.empty_cache()  # free what the (64, 64) plain products left cached: phase 2 needs 48 GB
    # time at the encode shape of the main path: RS(10,4) parity, 32 MiB columns
    from seaweedfs_tpu_torch.ec import gf

    R, k, n = 4, 10, 32 * MiB
    matrix = gf.parity_matrix(k, R)
    data = rand_u8((k, n), gen)
    out = torch.empty((R, n), dtype=torch.uint8, device="cuda")
    for _ in range(3):
        gm.gf_matmul(matrix, data, out=out)
    kern = cuda_ms(lambda: gm.gf_matmul(matrix, data, out=out), 20, reps=10)
    gm.gf_matmul_plain(matrix, data)
    plain = cuda_ms(lambda: gm.gf_matmul_plain(matrix, data), 3)
    bound_ms, bound_by = gf_bound_ms(R, k, n)
    ms = statistics.median(kern)
    state["kernel"] = {"ms": ms, "plain_ms": statistics.median(plain),
                       "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": max_err}
    emit({"phase": 1, "cases": cases, "mismatches": mismatches, "max_abs_err": max_err,
          "tolerance": 0,  # GF(2^8) arithmetic is exact: kernel and plain agree byte for byte
          "shape": [R, k, n], "kernel_ms": ms, "kernel_ms_runs": kern,
          "kernel_input_GBps": k * n / ms / 1e6, "plain_ms": statistics.median(plain),
          "bound_ms": bound_ms, "bound_by": bound_by, "nvidia_smi": state["smi"]})
    conc = concurrent_codecs()
    emit({"phase": 1, "concurrent_codecs": conc})
    emit({"kernels": [{"name": "gf_matmul", "launches": gm.gf_matmul.launches,
                       "mismatches": mismatches}]})
    if mismatches or conc["mismatches"]:
        raise SystemExit("phase 1: kernel disagrees with its plain version")


def concurrent_codecs(n_codecs: int = 4, width: int = 32 * MiB) -> dict:
    """Several volume servers in one process each own a CudaCodec (their own
    streams and pinned buffers), and the fleet scheduler runs up to 4
    generate jobs at once. Four codecs encode four host stripes of
    uint8[10, width] from four threads at once; each result must equal the
    plain version's, and the wall time is set beside four calls in a row on
    one codec, with the seconds spent allocating pinned memory."""
    from seaweedfs_tpu_torch.ec import gf

    rng = np.random.default_rng(11)
    matrix = gf.parity_matrix(10, 4)
    stripes = [rng.integers(0, 256, (10, width), dtype=np.uint8) for _ in range(n_codecs)]
    want = [gm.gf_matmul_plain(matrix, torch.from_numpy(d).cuda()).cpu().numpy()
            for d in stripes]
    codecs = [get_codec(device="cuda") for _ in range(n_codecs)]
    for c in codecs:  # first use of each codec's streams, untimed
        c.matmul(matrix, stripes[0][:, :MiB])
    t0 = time.perf_counter()
    serial = [codecs[0].matmul(matrix, d).copy() for d in stripes]
    serial_s = time.perf_counter() - t0
    got: list = [None] * n_codecs
    # pinned host memory: device_put pins its input, host_buffer allocates
    # the result's landing buffer
    timers = [(_Timer(c.device_put), _Timer(c.host_buffer)) for c in codecs]
    for c, (put, buf) in zip(codecs, timers):
        c.device_put, c.host_buffer = put, buf

    def run(i: int) -> None:
        got[i] = codecs[i].matmul(matrix, stripes[i]).copy()

    pool = [threading.Thread(target=run, args=(i,)) for i in range(n_codecs)]
    t0 = time.perf_counter()
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    concurrent_s = time.perf_counter() - t0
    bad = sum(int((g != w).sum()) for g, w in zip(got, want))
    bad += sum(int((g != w).sum()) for g, w in zip(serial, want))
    del codecs
    torch.cuda.empty_cache()
    return {"codecs": n_codecs, "shape": [10, width], "mismatches": bad,
            "serial_s": serial_s, "concurrent_s": concurrent_s,
            "device_put_s": [put.seconds for put, _ in timers],
            "host_buffer_s": [buf.seconds for _, buf in timers]}


def phase2(state) -> None:
    """Encode one default-size 30 GB volume held on the card."""
    k, m = 10, 4
    n = 3 * GiB  # 30 GB default -volumeSizeLimitMB striped over 10 data shards
    codec = get_codec()
    gen = torch.Generator(device="cuda").manual_seed(2)
    torch.cuda.reset_peak_memory_stats()
    data = rand_u8((k, n), gen)
    parity = torch.empty((m, n), dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    l0 = gm.gf_matmul.launches
    codec.matmul_device(codec.parity_rows, data, out=parity)  # warm-up
    torch.cuda.synchronize()
    per_run = gm.gf_matmul.launches - l0
    runs = cuda_ms(lambda: codec.matmul_device(codec.parity_rows, data, out=parity), 5)
    # check every parity byte against the plain version, 32 MiB at a time
    bad = err = 0
    for pos in range(0, n, 32 * MiB):
        want = gm.gf_matmul_plain(codec.parity_rows, data[:, pos:pos + 32 * MiB])
        b, e = compare(parity[:, pos:pos + 32 * MiB], want)
        bad, err = bad + b, max(err, e)
    p50 = statistics.median(runs)
    bound_ms, bound_by = gf_bound_ms(m, k, n)
    state["data"], state["parity"] = data, parity
    state["phase2_encode_ms"] = p50
    state["kernel"]["max_abs_err"] = max(state["kernel"]["max_abs_err"], err)
    emit({"phase": 2, "volume_bytes": k * n, "launches_per_encode": per_run,
          "encode_ms_p50": p50, "encode_ms_runs": runs,
          "input_GBps": k * n / p50 / 1e6, "bound_ms": bound_ms, "bound_by": bound_by,
          "mismatches": bad, "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
          "launches": gm.gf_matmul.launches - state["l_phase"],
          "nvidia_smi": state["smi"]})
    if bad:
        raise SystemExit("phase 2: parity disagrees with the plain version")


def phase3(state) -> None:
    """Rebuild shards {0, 3, 10, 13} of the phase-2 volume, chunk by chunk."""
    data, parity = state["data"], state["parity"]
    codec = get_codec()
    k, n, chunk = codec.data_shards, data.shape[1], codec.chunk_bytes
    present = [s for s in range(codec.total_shards) if s not in LOST]
    rows = encoder._rebuild_rows(codec, present, LOST)

    def shard(s, pos):
        return (data[s] if s < k else parity[s - k])[pos:pos + chunk]

    def mark() -> torch.cuda.Event:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def rebuild(check: bool) -> tuple[int, float, float, float]:
        """One pass; returns (mismatches, total ms, stacking ms, kernel ms),
        the last two summed over chunks from events around each step."""
        bad = 0
        marks = []
        out = torch.empty((len(LOST), chunk), dtype=torch.uint8, device="cuda")
        for pos in range(0, n, chunk):
            e0 = mark()
            survivors = torch.stack([shard(s, pos) for s in present[:k]])
            e1 = mark()
            got = codec.matmul_device(rows, survivors, out=out[:, :survivors.shape[1]])
            marks.append((e0, e1, mark()))
            if check:
                want = torch.stack([shard(s, pos) for s in LOST])
                bad += int((got != want).sum())
        marks[-1][2].synchronize()
        return (bad, marks[0][0].elapsed_time(marks[-1][2]),
                sum(a.elapsed_time(b) for a, b, _ in marks),
                sum(b.elapsed_time(c) for _, b, c in marks))

    bad = rebuild(check=True)[0]
    rebuild(check=False)  # warm-up: the first pass after the check ran ~3x slower
    runs = [rebuild(check=False)[1:] for _ in range(5)]
    p50, stack_p50, kern_p50 = (statistics.median(r[i] for r in runs) for i in range(3))
    emit({"phase": 3, "lost": LOST, "survivor_bytes": k * n, "rebuild_ms_p50": p50,
          "rebuild_ms_runs": [r[0] for r in runs], "survivor_GBps": k * n / p50 / 1e6,
          "stack_ms_p50": stack_p50, "kernel_ms_p50": kern_p50,
          "kernel_survivor_GBps": k * n / kern_p50 / 1e6,
          "mismatches": bad, "launches": gm.gf_matmul.launches - state["l_phase"],
          "nvidia_smi": state["smi"]})
    del state["data"], state["parity"]
    if bad:
        raise SystemExit("phase 3: rebuilt shards differ from the originals")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(8 * MiB), b""):
            h.update(block)
    return h.hexdigest()


def check_shards(base: str, codec) -> tuple[int, list[str]]:
    """(mismatched bytes, .vif sums) of the 14 shard files of ``base``: the
    data shards must be the striped .dat (1 MiB small-block rows, zero
    padded; a .dat under 10 GiB has no large rows), the parity the plain
    version applied to them on the card, and every shard's sha256 the one
    in the .vif."""
    k, m = codec.data_shards, codec.parity_shards
    dat_size = os.path.getsize(base + ".dat")
    shard_size = os.path.getsize(base + shard_ext(0))
    block = encoder.SMALL_BLOCK_SIZE
    n_rows = shard_size // block
    dat = np.zeros(n_rows * k * block, dtype=np.uint8)
    with open(base + ".dat", "rb") as f:
        f.readinto(memoryview(dat)[:dat_size])
    want_data = dat.reshape(n_rows, k, block).transpose(1, 0, 2).reshape(k, shard_size)
    shards = np.stack([np.fromfile(base + shard_ext(s), dtype=np.uint8) for s in range(k + m)])
    bad = int(np.count_nonzero(shards[:k] != want_data))
    dev = torch.from_numpy(shards[:k]).cuda()
    want_par = torch.cat([gm.gf_matmul_plain(codec.parity_rows, dev[:, p:p + 32 * MiB])
                          for p in range(0, shard_size, 32 * MiB)], dim=1)
    bad += int((want_par != torch.from_numpy(shards[k:]).cuda()).sum())
    del dev, want_par, dat, want_data, shards
    with open(base + ".vif") as f:
        sums = json.load(f)["shard_sums"]
    bad_sums = [s for s in range(k + m) if _sha256(base + shard_ext(s)) != sums[s]]
    if bad_sums:
        print(f"shard sums differ from the .vif: {bad_sums}", file=sys.stderr)
        bad += len(bad_sums)
    return bad, sums


def phase4(state) -> None:
    """File-level encode + rebuild of a 1 GiB volume."""
    codec = get_codec()
    k, m = codec.data_shards, codec.parity_shards
    base = os.path.join(WORK, "4")
    dat_size = GiB
    rng = np.random.default_rng(4)
    with open(base + ".dat", "wb") as f:
        f.write(SuperBlock(version=3).to_bytes())
        left = dat_size - 8
        while left:
            step = min(left, 64 * MiB)
            f.write(rng.bytes(step))
            left -= step
    open(base + ".idx", "wb").close()
    enc_stats: dict = {}
    t0 = time.perf_counter()
    ec_encode_volume(base, codec, version=3, pipeline_stats=enc_stats)
    enc_s = time.perf_counter() - t0

    bad, sums = check_shards(base, codec)
    shard_size = os.path.getsize(base + shard_ext(0))
    for s in LOST:
        os.remove(base + shard_ext(s))
    reb_stats: dict = {}
    t0 = time.perf_counter()
    rebuilt = encoder.rebuild_ec_files(base, codec, pipeline_stats=reb_stats)
    reb_s = time.perf_counter() - t0
    bad_sums = [s for s in range(k + m) if _sha256(base + shard_ext(s)) != sums[s]]
    emit({"phase": 4, "dat_bytes": dat_size, "shard_bytes": shard_size,
          "encode_wall_s": enc_s, "encode_GBps": dat_size / enc_s / 1e9,
          "encode_efficiency": enc_stats.get("efficiency"), "encode_stats": enc_stats,
          "rebuilt": rebuilt, "rebuild_wall_s": reb_s,
          "rebuild_survivor_GBps": k * shard_size / reb_s / 1e9,
          "rebuild_efficiency": reb_stats.get("efficiency"), "rebuild_stats": reb_stats,
          "mismatches": bad, "bad_shard_sums": bad_sums,
          "launches": gm.gf_matmul.launches - state["l_phase"],
          "nvidia_smi": state["smi"]})
    for name in os.listdir(WORK):
        if name.startswith("4."):
            os.remove(os.path.join(WORK, name))
    if bad or bad_sums or rebuilt != LOST:
        raise SystemExit("phase 4: shard files are wrong")


def phase5(state) -> None:
    """Needle volume: degraded reads with data shard 1 lost, then decode
    with data shards 1, 2 and 5 lost."""
    codec = get_codec()
    vid, version = 5, 3
    base = os.path.join(WORK, str(vid))
    rng = np.random.default_rng(5)
    blobs: dict[int, bytes] = {}
    total = 0
    with open(base + ".dat", "wb") as dat, open(base + ".idx", "wb") as idx:
        dat.write(SuperBlock(version=version).to_bytes())
        offset = dat.tell()
        nid = 0
        while total < 16 * MiB:  # sizes log-uniform in 1..64 KiB
            nid += 1
            size = int(np.exp(rng.uniform(np.log(1024), np.log(64 * 1024))))
            blobs[nid] = rng.bytes(size)
            n = Needle(cookie=int(rng.integers(1 << 32)), id=nid, data=blobs[nid])
            rec = n.to_bytes(version)
            dat.write(rec)
            idx.write(idx_mod.pack_entry(nid, offset, n.size))
            offset += len(rec)
            total += size
    with open(base + ".dat", "rb") as f:
        orig_dat = f.read()
    with open(base + ".idx", "rb") as f:
        orig_idx = f.read()
    ec_encode_volume(base, codec, version=version)
    os.remove(base + shard_ext(1))

    l0 = gm.gf_matmul.launches
    ev = EcVolume(WORK, "", vid, version=version)
    t0 = time.perf_counter()
    bad_reads = 0
    try:
        for nid, want in blobs.items():
            if read_ec_shard_needle(ev, codec, nid).data != want:
                bad_reads += 1
    finally:
        ev.close()
    read_s = time.perf_counter() - t0
    read_launches = gm.gf_matmul.launches - l0

    os.remove(base + ".dat")
    os.remove(base + ".idx")
    for s in (2, 5):
        os.remove(base + shard_ext(s))
    l0 = gm.gf_matmul.launches
    t0 = time.perf_counter()
    dat_size = decode_to_volume(base, codec=codec)
    decode_s = time.perf_counter() - t0
    decode_launches = gm.gf_matmul.launches - l0
    with open(base + ".dat", "rb") as f:
        dat_ok = f.read() == orig_dat
    with open(base + ".idx", "rb") as f:
        idx_ok = f.read() == orig_idx
    emit({"phase": 5, "needles": len(blobs), "data_bytes": total,
          "dat_bytes": len(orig_dat), "degraded_read_s": read_s, "bad_reads": bad_reads,
          "read_launches": read_launches, "decode_s": decode_s, "decoded_dat_bytes": dat_size,
          "dat_identical": dat_ok, "idx_identical": idx_ok, "decode_launches": decode_launches,
          "launches": gm.gf_matmul.launches - state["l_phase"]})
    if bad_reads or not (dat_ok and idx_ok) or not read_launches or not decode_launches:
        raise SystemExit("phase 5: needle volume round trip failed")


def _pct(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q))


def _call(url: str, method: str, path: str, body: bytes = b"") -> tuple[int, bytes, float]:
    """One request on a fresh connection: (status, body, seconds)."""
    conn = http.client.HTTPConnection(url, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, data, time.perf_counter() - t0
    finally:
        conn.close()


def _until(cond, timeout: float = 30.0) -> bool:
    """Poll ``cond`` until it holds or ``timeout`` seconds pass."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.1)
    return bool(cond())


def _admin(url: str, path: str) -> dict:
    status, data, _ = _call(url, "POST", path)
    if status != 200:
        raise SystemExit(f"POST {path} answered {status}: {data[:300]!r}")
    return json.loads(data)


class _Timer:
    """Wraps a callable, adding its calls' seconds to ``seconds`` (summed
    over the threads that call it)."""

    def __init__(self, fn):
        self.fn, self.seconds, self.calls = fn, 0.0, 0
        self.lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kwargs)
        finally:
            with self.lock:
                self.seconds += time.perf_counter() - t0
                self.calls += 1


class _Timed:
    """Within the block, the named attributes of each object are wrapped in
    ``_Timer``s (``timers[name]``); on exit the originals are back."""

    def __init__(self, *targets):
        self.targets = targets  # (object, attribute name)
        self.timers: dict[str, _Timer] = {}

    def __enter__(self):
        self.saved = [(obj, name, obj.__dict__.get(name)) for obj, name in self.targets]
        for obj, name in self.targets:
            self.timers[name] = _Timer(getattr(obj, name))
            setattr(obj, name, self.timers[name])
        return self.timers

    def __exit__(self, *exc):
        for obj, name, old in self.saved:
            if old is None:
                delattr(obj, name)  # an instance attribute over a method
            else:
                setattr(obj, name, old)


class _Engines:
    """The turbo engines of a phase's volume servers. ``check`` fails the
    phase if one started without its engine (naming why); ``stop`` stops a
    server after reading its counters; ``totals`` sums the counters of the
    live engines and of the stopped ones."""

    def __init__(self, phase: int, servers: list):
        self.phase, self.servers = phase, servers
        self.done: collections.Counter = collections.Counter()

    def check(self) -> None:
        off = {f"127.0.0.1:{vs.port}": vs.turbo_status()["reason"]
               for vs in self.servers if vs.turbo is None}
        if off:
            raise SystemExit(f"phase {self.phase}: the turbo engine is off: {off}")

    def stop(self, vs) -> None:
        if vs.turbo is not None:
            self.done.update(vs.turbo.counters())
        vs.stop()

    def totals(self) -> dict:
        tot = collections.Counter(self.done)
        for vs in self.servers:
            if vs.turbo is not None:
                tot.update(vs.turbo.counters())
        return {k: tot[k] for k in ("gets", "posts", "deletes", "proxied")}


def phase6(state) -> None:
    """The server path: a port VolumeServer with the CUDA backend, beside the
    port's master, takes a 1 GiB needle volume over HTTP, encodes it, serves
    degraded reads with shards {0, 3, 10, 13} lost, rebuilds them, and
    decodes the volume back, each EC step through its admin endpoint."""
    vid, k, threads = 6, 10, 8
    master = MasterServer(host="127.0.0.1", port=_free_port()).start()
    srv_dir = os.path.join(WORK, "6srv")
    base = os.path.join(srv_dir, str(vid))
    port = _free_port()
    vs = VolumeServer([srv_dir], host="127.0.0.1", port=port, master_url=master.url,
                      pulse_seconds=1.0, ec_backend=EC_BACKEND)
    url = f"127.0.0.1:{port}"
    out: dict = {"phase": 6}
    steps: dict = {}

    def step(name: str, fn):
        l0 = gm.gf_matmul.launches
        res = fn()
        steps[name] = gm.gf_matmul.launches - l0
        return res

    eng = _Engines(6, [vs])
    try:
        vs.start()
        eng.check()
        _admin(url, f"/admin/assign_volume?volume={vid}&replication=000")

        # needles with sizes log-uniform in 1 KiB..1 MiB until the .dat
        # holds 1 GiB, fids made here, uploaded from 8 client threads
        rng = np.random.default_rng(6)
        blobs, total = [], 8
        while total < GiB:
            size = int(np.exp(rng.uniform(np.log(1024), np.log(MiB))))
            fid = str(FileId(vid, len(blobs) + 1, int(rng.integers(1, 1 << 32))))
            blobs.append((fid, rng.bytes(size)))
            total += get_actual_size(size, 3)
        nxt = iter(range(len(blobs)))
        lat = [[] for _ in range(threads)]
        errors: list = []

        def upload(t: int) -> None:
            conn = http.client.HTTPConnection(url, timeout=120)
            try:
                for i in nxt:  # a shared iterator: each index goes to one thread
                    fid, data = blobs[i]
                    t0 = time.perf_counter()
                    conn.request("POST", "/" + fid, body=data)
                    resp = conn.getresponse()
                    resp.read()
                    lat[t].append(time.perf_counter() - t0)
                    if resp.status != 201:
                        errors.append((fid, resp.status))
                        return
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))
            finally:
                conn.close()

        # server-side busy seconds, summed over request threads: the master
        # lookup each POST makes (for replicas) and the volume append
        with _Timed((vs, "_lookup"), (vs.store, "write_volume_needle")) as busy:
            t0 = time.perf_counter()
            pool = [threading.Thread(target=upload, args=(t,)) for t in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join()
            write_s = time.perf_counter() - t0
        if errors:
            raise SystemExit(f"phase 6: uploads failed: {errors[:5]}")
        post_ms = [x * 1e3 for xs in lat for x in xs]
        payload = sum(len(d) for _, d in blobs)
        out.update(needles=len(blobs), payload_bytes=payload, write_s=write_s,
                   write_MBps=payload / write_s / 1e6, post_ms_p50=_pct(post_ms, 50),
                   post_ms_p99=_pct(post_ms, 99), client_threads=threads,
                   post_lookup_busy_s=busy["_lookup"].seconds,
                   post_append_busy_s=busy["write_volume_needle"].seconds)

        # encode through the admin surface
        _admin(url, f"/admin/readonly?volume={vid}")
        # the seal's fsync and the striping pipeline, apart from the rest
        # (.ecx, shard sha256 sums, commit)
        with _Timed((vs.store.find_volume(vid), "sync"), (encoder, "write_ec_files")) as gt:
            gen = step("generate", lambda: _admin(url, f"/admin/ec/generate?volume={vid}"))
        dat_sha, dat_bytes = _sha256(base + ".dat"), os.path.getsize(base + ".dat")
        with open(base + ".idx", "rb") as f:
            orig_idx = f.read()
        codec = vs.store.ec_codec
        bad, sums = check_shards(base, codec)
        out.update(dat_bytes=dat_bytes, generate_s=gen["seconds"], generate_bytes=gen["bytes"],
                   generate_GBps=gen["bytes"] / gen["seconds"] / 1e9,
                   generate_seal_s=gt["sync"].seconds,
                   generate_stripe_s=gt["write_ec_files"].seconds, shard_mismatches=bad)
        if bad or gen["shards"] != list(range(14)):
            raise SystemExit("phase 6: generated shards are wrong")
        mounted = _admin(url, f"/admin/ec/mount?volume={vid}")["shards"]
        if not _admin(url, f"/admin/delete_volume?volume={vid}")["deleted"] or len(mounted) != 14:
            raise SystemExit("phase 6: the EC volume did not take over from the plain one")

        # degraded reads: needles with a block on a lost data shard
        removed = _admin(url, f"/admin/ec/delete_shards?volume={vid}&shards="
                              + ",".join(map(str, LOST)))["removed"]
        if removed != LOST:
            raise SystemExit(f"phase 6: delete_shards removed {removed}")
        block = encoder.SMALL_BLOCK_SIZE
        offsets = {key: (off, size) for key, off, size in
                   idx_mod.iter_index_file(io.BytesIO(orig_idx))}
        lost_data = {s for s in LOST if s < k}

        def on_lost(i: int) -> bool:
            off, size = offsets[i + 1]
            end = off + get_actual_size(size, 3)
            return any(b % k in lost_data for b in range(off // block, (end - 1) // block + 1))

        pick = [int(i) for i in np.random.default_rng(66).permutation(len(blobs))
                if on_lost(int(i))][:64]
        store = vs.store
        get_ms, bad_reads = [], 0
        l0 = gm.gf_matmul.launches
        with _Timed((store, "_remote_shard_read"), (codec, "reconstruct"),
                    (codec, "host_buffer")) as rt:
            for i in pick:
                fid, want = blobs[i]
                status, data, sec = _call(url, "GET", "/" + fid)
                get_ms.append(sec * 1e3)
                bad_reads += status != 200 or data != want
        steps["degraded_get"] = gm.gf_matmul.launches - l0
        out.update(degraded_reads=len(pick), bad_reads=bad_reads,
                   get_ms_p50=_pct(get_ms, 50), get_ms_p99=_pct(get_ms, 99),
                   get_s=sum(get_ms) / 1e3, remote_fetch_s=rt["_remote_shard_read"].seconds,
                   remote_fetch_calls=rt["_remote_shard_read"].calls,
                   reconstruct_s=rt["reconstruct"].seconds,
                   reconstruct_calls=rt["reconstruct"].calls,
                   pinned_alloc_s=rt["host_buffer"].seconds,
                   retry_policy={"attempts": store.remote_fetch_attempts,
                                 "backoff_s": store.remote_fetch_backoff_s})
        if bad_reads or len(pick) < 64:
            raise SystemExit(f"phase 6: {bad_reads} of {len(pick)} degraded reads wrong")

        # rebuild the lost shards, then decode with data shards 1, 2, 5 lost
        reb = step("rebuild", lambda: _admin(url, f"/admin/ec/rebuild?volume={vid}"))
        bad_sums = [s for s in LOST if _sha256(base + shard_ext(s)) != sums[s]]
        out.update(rebuild_s=reb["seconds"], rebuilt=reb["rebuilt_shards"], bad_shard_sums=bad_sums)
        if bad_sums or reb["rebuilt_shards"] != LOST:
            raise SystemExit("phase 6: rebuilt shards differ from the .vif sums")
        _admin(url, f"/admin/ec/delete_shards?volume={vid}&shards=1,2,5")
        with _Timed((decoder, "rebuild_ec_files"), (decoder, "write_dat_file")) as dt:
            dec = step("to_volume", lambda: _admin(url, f"/admin/ec/to_volume?volume={vid}"))
        with open(base + ".idx", "rb") as f:
            idx_now = f.read()
        # the decoded .idx lists the entries in key order (it is made from
        # the .ecx), the written one in the order the 8 threads appended
        # (keys are big-endian, so byte order is key order)
        key_order = b"".join(sorted(orig_idx[i:i + 16] for i in range(0, len(orig_idx), 16)))
        dat_ok = _sha256(base + ".dat") == dat_sha and dec["dat_size"] == dat_bytes
        idx_ok = idx_now == key_order
        out.update(to_volume_s=dec["seconds"], to_volume_rebuild_s=dt["rebuild_ec_files"].seconds,
                   to_volume_destripe_s=dt["write_dat_file"].seconds, dat_identical=dat_ok,
                   idx_identical_in_key_order=idx_ok, file_count=dec["file_count"])
        status, data, _ = _call(url, "GET", "/" + blobs[pick[0]][0])
        if not (dat_ok and idx_ok) or (status, data) != (200, blobs[pick[0]][1]):
            raise SystemExit(f"phase 6: the decoded volume differs from the original "
                             f"(dat {dat_ok}, idx {idx_ok}, GET {status})")
    finally:
        eng.stop(vs)
        master.stop()
    out.update(turbo=eng.totals(), crc=crc.implementation(), step_launches=steps,
               launches=gm.gf_matmul.launches - state["l_phase"], nvidia_smi=state["smi"])
    emit(out)
    if out["crc"] != "native":
        raise SystemExit("phase 6: the needle CRC is not the native build")
    idle = [name for name, n in steps.items() if not n]
    if idle:
        raise SystemExit(f"phase 6: no kernel launch in {idle}")


# -- phase 7: the query engine ------------------------------------------------
# four needles (eight before PR 16's cut: PERF.md section 4) of the filer's
# default chunk size
QUERY_NEEDLES, QUERY_NEEDLE_BYTES = 4, 32 * MiB
ORACLE_BYTES = 4 * MiB
# the query probe's requests (bench.py probe_query) and five more, each kind
# of leaf once; some as where dicts, some as SQL
QUERIES = [
    ("probe", {"select": ["id", "name"], "where": {"and": [
        {"field": "region", "op": "=", "value": "east"},
        {"field": "score", "op": ">", "value": 995}]}}),
    ("contains", {"sql": "SELECT * FROM s3object WHERE name LIKE '%r00012%'"}),
    ("starts_with", {"sql": "SELECT id, name FROM s3object WHERE name LIKE 'r00001%'"}),
    ("lex_lt", {"select": ["id", "name"],
                "where": {"field": "name", "op": "<", "value": "r0000100"}}),
    ("not_or", {"sql": "SELECT id FROM s3object WHERE NOT region = 'west' OR score <= 3.5"}),
    ("limit", {"sql": "SELECT * FROM s3object LIMIT 10"}),
]


def _digits(v: np.ndarray, width: int, strip: bool) -> tuple[np.ndarray, np.ndarray]:
    """ASCII digits of ``v`` in ``width`` columns, with a mask that keeps
    them all or (``strip``) drops the leading zeros."""
    pw = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    mat = ((v[:, None] // pw) % 10 + 48).astype(np.uint8)
    keep = (v[:, None] >= pw) | (pw == 1) if strip else np.ones(mat.shape, dtype=bool)
    return mat, keep


def query_csv(seed: int, size: int) -> bytes:
    """A CSV object of the query probe's schema ``id,region,score,name``: id
    the row number, region one of four, score a two-decimal number in
    [0, 1000), name ``r`` and 7 digits; the rows are drawn from ``seed`` and
    cut to the whole rows under ``size`` bytes. Built as one byte matrix and
    a keep mask, so 32 MiB takes well under a second."""
    rng = np.random.default_rng(seed)
    n = size // 24
    reg = rng.integers(0, 4, n)
    cents = rng.integers(0, 100_000, n)
    names = rng.integers(0, 10 ** 7, n)
    tab = np.zeros((4, 5), dtype=np.uint8)
    for i, r in enumerate((b"east", b"west", b"north", b"south")):
        tab[i, :len(r)] = np.frombuffer(r, np.uint8)
    reg_len = np.array([4, 4, 5, 5])

    def const(b: bytes):
        return (np.broadcast_to(np.frombuffer(b, np.uint8), (n, len(b))),
                np.ones((n, len(b)), dtype=bool))

    cols = [_digits(np.arange(n), 7, True), const(b","),
            (tab[reg], np.arange(5)[None, :] < reg_len[reg][:, None]), const(b","),
            _digits(cents // 100, 3, True), const(b"."), _digits(cents % 100, 2, False),
            const(b",r"), _digits(names, 7, False), const(b"\n")]
    mat = np.concatenate([c[0] for c in cols], axis=1)
    keep = np.concatenate([c[1] for c in cols], axis=1)
    data = (b"id,region,score,name\n" + mat[keep].tobytes())[:size]
    return data[: data.rfind(b"\n") + 1]


def exact_lane_csv(data: bytes, seed: int, size: int) -> bytes:
    """``data`` with 1 % of the scores written as ``9.953700e+02`` and 1 % of
    the names starting with a non-ASCII letter: rows only the exact lane
    decides. Cut again to the whole rows under ``size`` bytes."""
    lines = data.split(b"\n")
    rng = np.random.default_rng(seed)
    body = np.arange(1, len(lines) - 1)
    for i in rng.choice(body, len(body) // 100, replace=False):
        f = lines[i].split(b",")
        lines[i] = b",".join((f[0], f[1], b"%e" % float(f[2]), f[3]))
    for i in rng.choice(body, len(body) // 100, replace=False):
        f = lines[i].split(b",")
        lines[i] = b",".join((f[0], f[1], f[2], "ř".encode() + f[3][1:]))
    out = b"\n".join(lines)[:size]
    return out[: out.rfind(b"\n") + 1]


def numeric_edge_check() -> dict:
    """The scan's numeric parse on the card against ``float()`` at the edge
    of its domain: 15-digit mantissas with 1-14 fractional digits (both
    signs, fixed and 2000 drawn from a seed), and ``0.1``, ``-0``, ``5.``,
    ``.5``, ``99999999999999.9``. A simple-domain value must equal float()
    bit for bit; ``5.`` and ``.5`` must go to the exact lane."""
    rng = np.random.default_rng(17)
    texts = ["0.1", "-0", "5.", ".5", "99999999999999.9", "0.000000000000001", "-0.0"]
    for f in range(1, 15):
        for m in ("123456789012345", "-987654321098765", "999999999999999"):
            texts.append(m[:len(m) - f] + "." + m[len(m) - f:])
    for _ in range(2000):
        digits = "".join(map(str, rng.integers(0, 10, 15)))
        f = int(rng.integers(1, 15))
        texts.append(("-" if rng.random() < 0.5 else "") + digits[:15 - f] + "." + digits[15 - f:])
    k = TorchKernels("cuda")
    w = max(len(t) for t in texts)
    mat = np.zeros((len(texts), w), dtype=np.uint8)
    for i, t in enumerate(texts):
        mat[i, :len(t)] = np.frombuffer(t.encode(), np.uint8)
    lens = torch.tensor([len(t) for t in texts], dtype=torch.int32, device=k.device)
    vals, simple, not_float = (x.cpu().numpy() for x in query_scan._numeric(
        torch.from_numpy(mat).to(k.device), lens, k.ten_pows, k.floatish))
    bad = [t for t, v, s in zip(texts, vals, simple)
           if s and np.float64(float(t)).view(np.int64) != np.float64(v).view(np.int64)]
    bad += [t for t in ("5.", ".5") if simple[texts.index(t)] or not_float[texts.index(t)]]
    bad += [t for t in ("0.1", "-0", "99999999999999.9") if not simple[texts.index(t)]]
    return {"cases": len(texts), "simple": int(simple.sum()), "mismatches": bad[:10]}


def _query_args(req: dict) -> tuple:
    """(select, where, limit) of a request, as the port's scan_request reads it."""
    if "sql" in req:
        return parse_sql(req["sql"])
    return req.get("select"), req.get("where"), req.get("limit", 0)


def _split_query(vs, fid: str, req: dict) -> dict:
    """One query's time split apart, outside the latency runs: the needle
    fetch, the host structural index (segment scan and field vectors), the
    H2D copies, the tree's evaluation, the masks' D2H copy and the row
    building, with the reply's JSON encoding. Host seconds exclude nested
    timed calls; the three device steps are timed by CUDA events around
    them (``*_device_ms``)."""
    t0 = time.perf_counter()
    status, data = vs._fetch_fid(fid)
    fetch_s = time.perf_counter() - t0
    if status != 200:
        raise SystemExit(f"phase 7: fetch {fid} answered {status}")
    plan = compile_plan(*_query_args(req), input_format="csv", backend="cuda")
    host: dict = collections.defaultdict(float)
    events: list = []
    stack: list = []

    def wrap(obj, name: str, device: bool) -> None:
        fn = getattr(obj, name)

        def timed(*args, **kwargs):
            if device:
                a = torch.cuda.Event(enable_timing=True)
                a.record()
            stack.append(0.0)
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t
                host[name] += dt - stack.pop()
                if stack:
                    stack[-1] += dt
                if device:
                    b = torch.cuda.Event(enable_timing=True)
                    b.record()
                    events.append((name, a, b))

        setattr(obj, name, timed)  # on this plan only: it is thrown away

    for name in ("_csv_segment", "_field_vectors", "_csv_batch"):
        wrap(plan, name, False)
    for name in ("stage", "evaluate", "to_host"):
        wrap(plan.kernels, name, True)
    t0 = time.perf_counter()
    rows = plan.execute(data)
    total_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    dev: dict = collections.defaultdict(float)
    for name, a, b in events:
        dev[name] += a.elapsed_time(b)
    t0 = time.perf_counter()
    json.dumps({"rows": rows, "count": len(rows)})
    encode_s = time.perf_counter() - t0
    parts = {"index_s": host["_csv_segment"] + host["_field_vectors"],
             "stage_s": host["stage"], "evaluate_enqueue_s": host["evaluate"],
             "to_host_s": host["to_host"], "row_build_s": host["_csv_batch"]}
    return {"fetch_s": fetch_s, **parts, "scan_s": total_s,
            "scan_other_s": total_s - sum(parts.values()), "json_encode_s": encode_s,
            "stage_device_ms": dev["stage"], "evaluate_device_ms": dev["evaluate"],
            "to_host_device_ms": dev["to_host"],
            "evaluations": sum(1 for e in events if e[0] == "evaluate"), "rows": len(rows)}


def _profile_query(data: bytes, req: dict) -> dict:
    """Kernel launches per tree evaluation and the card's busy time during
    one scan, from torch.profiler's device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    plan = compile_plan(*_query_args(req), input_format="csv", backend="cuda")
    e0 = TorchKernels.evaluations["cuda"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        plan.execute(data)
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    evals = TorchKernels.evaluations["cuda"] - e0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    return {"evaluations": evals, "kernels": len(kernels),
            "kernels_per_evaluation": len(kernels) / max(evals, 1),
            "kernel_us": sum(e.time_range.elapsed_us() for e in kernels),
            "copy_us": busy_us - sum(e.time_range.elapsed_us() for e in kernels),
            "profiled_wall_s": wall_s, "busy_share": busy_us / 1e6 / wall_s}


def phase7(state) -> None:
    """The query path: a port VolumeServer (CUDA backend) beside the port's
    master holds four 32 MiB CSV needles; six /_query requests per needle
    run the scan's predicate tree on the card, each reply held against the
    cpu backend's rows, and on 4 MiB of the last against the row-at-a-time
    engine. Then the port shell's ``ec.encode -fleet`` encodes the volume
    through the master's fleet scheduler, the shard holding needle 3 is
    lost, and the probe query on needle 3 reads through gf_matmul."""
    vid = 7
    master = MasterServer(host="127.0.0.1", port=_free_port()).start()
    srv_dir = os.path.join(WORK, "7srv")
    port = _free_port()
    vs = VolumeServer([srv_dir], host="127.0.0.1", port=port, master_url=master.url,
                      pulse_seconds=1.0, ec_backend=EC_BACKEND)
    url = f"127.0.0.1:{port}"
    out: dict = {"phase": 7, "scan_backend": "cuda", "numeric_edge": numeric_edge_check()}
    if out["numeric_edge"]["mismatches"]:
        raise SystemExit(f"phase 7: numeric parse differs from float(): {out['numeric_edge']}")
    cnt = QUERY_COUNTERS
    try:
        vs.start()
        _admin(url, f"/admin/assign_volume?volume={vid}&replication=000")
        t0 = time.perf_counter()
        needles = [query_csv(70 + i, QUERY_NEEDLE_BYTES) for i in range(QUERY_NEEDLES)]
        needles[-1] = exact_lane_csv(needles[-1], 77, QUERY_NEEDLE_BYTES)
        fids = [str(FileId(vid, i + 1, 0x7000 + i)) for i in range(QUERY_NEEDLES)]
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for fid, data in zip(fids, needles):
            status, body, _ = _call(url, "POST", "/" + fid, data)
            if status != 201:
                raise SystemExit(f"phase 7: upload {fid} answered {status}: {body[:200]!r}")
        out.update(needles=len(needles), needle_bytes=[len(d) for d in needles],
                   data_gen_s=gen_s, upload_s=time.perf_counter() - t0)

        def ask(fid: str, req: dict) -> tuple[dict, float]:
            status, body, sec = _call(url, "POST", "/_query",
                                      json.dumps(dict(req, fid=fid, input="csv")).encode())
            if status != 200:
                raise SystemExit(f"phase 7: /_query {fid} answered {status}: {body[:300]!r}")
            return json.loads(body), sec

        t0 = time.perf_counter()
        for _, req in QUERIES:  # first use of each op on the card, untimed
            ask(fids[0], req)
        out["warmup_s"] = time.perf_counter() - t0

        torch.cuda.reset_peak_memory_stats()
        e0, s0 = TorchKernels.evaluations["cuda"], cnt["scans"].value(backend="cuda")
        per_query, mismatches, probe3 = {}, [], None
        for name, req in QUERIES:
            lat, rows, kern, fall = [], 0, 0, 0
            for i, (fid, data) in enumerate(zip(fids, needles)):
                k0, f0 = cnt["kernel"].total(), cnt["fallback"].total()
                got, sec = ask(fid, req)
                kern += cnt["kernel"].total() - k0
                fall += cnt["fallback"].total() - f0
                lat.append(sec)
                rows += got["count"]
                want = execute_request(data, dict(req, input="csv"), backend="cpu")[1]
                if got != want:
                    mismatches.append((name, i))
                if name == "probe" and i == 3:
                    probe3 = got
            mb = [len(d) / s / 1e6 for d, s in zip(needles, lat)]
            per_query[name] = {"ms_p50": _pct(lat, 50) * 1e3, "ms_p99": _pct(lat, 99) * 1e3,
                               "ms_runs": [s * 1e3 for s in lat], "MBps_p50": _pct(mb, 50),
                               "rows": rows, "rows_kernel": kern, "rows_fallback": fall}
        out.update(queries=per_query, evaluations=TorchKernels.evaluations["cuda"] - e0,
                   scans_cuda=cnt["scans"].value(backend="cuda") - s0,
                   peak_mem_GB=torch.cuda.max_memory_allocated() / 1e9,
                   mismatches_vs_cpu=mismatches)
        if mismatches:
            raise SystemExit(f"phase 7: cuda replies differ from the cpu backend's: {mismatches}")
        if not sum(q["rows_kernel"] for q in per_query.values()):
            raise SystemExit("phase 7: no row was decided on the card")

        # the row-at-a-time oracle on the first 4 MiB of the last needle
        piece = needles[-1][:ORACLE_BYTES]
        piece = piece[: piece.rfind(b"\n") + 1]
        bad_oracle = []
        t0 = time.perf_counter()
        for name, req in QUERIES:
            select, where, limit = _query_args(req)
            want = run_query(piece, "csv", select=select, where=where, limit=limit)
            if execute_request(piece, dict(req, input="csv"), backend="cuda")[1]["rows"] != want:
                bad_oracle.append(name)
        out.update(oracle_bytes=len(piece), oracle_s=time.perf_counter() - t0,
                   oracle_mismatches=bad_oracle)
        if bad_oracle:
            raise SystemExit(f"phase 7: the scan differs from the engine on {bad_oracle}")

        # the split of one 32 MiB query into its steps, and launches per batch
        out["split"] = {name: _split_query(vs, fids[0], req) for name, req in QUERIES}
        _profile_query(needles[0], QUERIES[0][1])  # the profiler's first start is slow
        out["profile"] = {name: _profile_query(needles[0], req) for name, req in QUERIES}

        # EC: the needles' volume encoded, the shard with needle 3's first
        # block lost; the probe query on needle 3 reads through gf_matmul
        base = os.path.join(srv_dir, str(vid))
        with open(base + ".idx", "rb") as f:
            offsets = {key: off for key, off, _ in idx_mod.iter_index_file(io.BytesIO(f.read()))}
        if not _until(lambda: master.master.lookup_volume(vid)):
            raise SystemExit(f"phase 7: the master never learnt of volume {vid}")
        l0 = gm.gf_matmul.launches
        res = run_command(CommandEnv(master.url), f"ec.encode -volumeId={vid} -fleet")
        gen_launches = gm.gf_matmul.launches - l0
        (job,) = res["jobs"]
        status = json.loads(_call(url, "GET", "/status")[1])
        if job["state"] != "done" or job["server"] != url or status["volumes"] \
                or res["volumes"][0]["spread"] != {url: list(range(14))}:
            raise SystemExit(f"phase 7: ec.encode -fleet did not take over: {res}")
        gen = {"seconds": job["seconds"]}
        lost = (offsets[FileId.parse(fids[3]).key] // encoder.SMALL_BLOCK_SIZE) % 10
        if _admin(url, f"/admin/ec/delete_shards?volume={vid}&shards={lost}")["removed"] != [lost]:
            raise SystemExit(f"phase 7: shard {lost} was not deleted")

        def ec_only() -> bool:  # the delta beats reach the master
            held = master.master.lookup_ec_volume(vid)["shard_id_locations"]
            return not master.master.topo.lookup("", vid) and url in held.get(0, []) \
                and lost not in held
        _until(ec_only)
        l0, s0 = gm.gf_matmul.launches, cnt["scans"].value(backend="cuda")
        got, sec = ask(fids[3], QUERIES[0][1])
        out.update(ec={"encode": "ec.encode -fleet", "generate_s": gen["seconds"],
                       "generate_launches": gen_launches,
                       "lost_shard": lost, "query_ms": sec * 1e3,
                       "query_launches": gm.gf_matmul.launches - l0,
                       "scans_cuda": cnt["scans"].value(backend="cuda") - s0,
                       "rows": got["count"], "rows_equal_plain": got == probe3})
        if got != probe3 or not out["ec"]["query_launches"] or not gen_launches \
                or out["ec"]["scans_cuda"] != 1:
            raise SystemExit(f"phase 7: the EC-needle query failed: {out['ec']}")
    finally:
        vs.stop()
        master.stop()
    out.update(launches=gm.gf_matmul.launches - state["l_phase"], nvidia_smi=state["smi"])
    emit(out)


# -- phase 8: the cluster path -------------------------------------------------
# phases 8 and 9 fill a volume to this much .dat: 512 MiB since phase 10
# came (1 GiB before), so the whole script stays well inside its time limit
CLUSTER_BYTES = 512 * MiB


def _needle_blobs(seed: int, fill: int = 0) -> list:
    """Needles of log-uniform sizes in 1 KiB..1 MiB until their records fill
    ``fill`` (CLUSTER_BYTES by default) of .dat."""
    rng = np.random.default_rng(seed)
    blobs, total = [], 8
    while total < (fill or CLUSTER_BYTES):
        size = int(np.exp(rng.uniform(np.log(1024), np.log(MiB))))
        blobs.append(rng.bytes(size))
        total += get_actual_size(size, 3)
    return blobs


def _upload_via_master(master_url: str, col: str, blobs: list, threads: int):
    """Upload ``blobs`` from ``threads`` client threads, each fid from
    ``/dir/assign``: (fids, assign ms per thread, POST ms per thread,
    seconds, errors)."""
    fids: list = [None] * len(blobs)
    nxt = iter(range(len(blobs)))
    assign_ms = [[] for _ in range(threads)]
    post_ms = [[] for _ in range(threads)]
    errors: list = []

    def upload(t: int) -> None:
        mconn = http.client.HTTPConnection(master_url, timeout=120)
        vconns: dict = {}
        try:
            for i in nxt:  # a shared iterator: each index goes to one thread
                t0 = time.perf_counter()
                mconn.request("GET", f"/dir/assign?collection={col}")
                resp = mconn.getresponse()
                a = json.loads(resp.read())
                t1 = time.perf_counter()
                if resp.status != 200:
                    errors.append(("assign", resp.status, a))
                    return
                conn = vconns.setdefault(
                    a["url"], http.client.HTTPConnection(a["url"], timeout=120))
                conn.request("POST", "/" + a["fid"], body=blobs[i])
                resp = conn.getresponse()
                resp.read()
                assign_ms[t].append((t1 - t0) * 1e3)
                post_ms[t].append((time.perf_counter() - t1) * 1e3)
                if resp.status != 201:
                    errors.append((a["fid"], resp.status))
                    return
                fids[i] = a["fid"]
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append(repr(e))
        finally:
            mconn.close()
            for c in vconns.values():
                c.close()

    t0 = time.perf_counter()
    pool = [threading.Thread(target=upload, args=(t,)) for t in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    return fids, assign_ms, post_ms, time.perf_counter() - t0, errors


def _client_get(master_url: str, fid: str) -> tuple[int, bytes, float, str]:
    """A client's read: the master's lookup, then the first location.
    Returns (status, body, seconds, the location asked)."""
    t0 = time.perf_counter()
    status, body, _ = _call(master_url, "GET", f"/dir/lookup?volumeId={fid.split(',')[0]}")
    if status != 200:
        return status, body, time.perf_counter() - t0, ""
    loc = json.loads(body)["locations"][0]["url"]
    status, data, _ = _call(loc, "GET", "/" + fid)
    return status, data, time.perf_counter() - t0, loc


def _parallel(fn, items: list, threads: int) -> float:
    """Run ``fn(item)`` over ``items`` from ``threads`` threads; seconds."""
    nxt = iter(items)

    def work() -> None:
        for item in nxt:  # a shared iterator: each item goes to one thread
            fn(item)

    t0 = time.perf_counter()
    pool = [threading.Thread(target=work) for _ in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    return time.perf_counter() - t0


READ_BACK_SAMPLE = 1024  # needles read back at the end of phases 8, 9, 11 and 14e (a cut)


def _sample(items: list, n: int, seed: int) -> list:
    """A seeded ``n`` of ``items`` in their order (all of them when fewer):
    the read-backs' cut, PERF.md section 4."""
    if len(items) <= n:
        return list(items)
    return [items[i] for i in sorted(np.random.default_rng(seed).choice(len(items), n,
                                                                         replace=False))]


class _ShellCalls:
    """Within the block, every HTTP call the shell's commands make is timed
    by its path (``/admin/ec/copy``, ...): ``seconds[path]``, ``calls[path]``."""

    def __enter__(self):
        self.seconds: dict = collections.defaultdict(float)
        self.calls: dict = collections.defaultdict(int)
        self.saved = shell_commands.http_json

        def timed(method, url, *args, **kwargs):
            path = urllib.parse.urlsplit(url).path
            t0 = time.perf_counter()
            try:
                return self.saved(method, url, *args, **kwargs)
            finally:
                self.seconds[path] += time.perf_counter() - t0
                self.calls[path] += 1

        shell_commands.http_json = timed
        return self

    def __exit__(self, *exc):
        shell_commands.http_json = self.saved


def _shards_of(offsets: dict, key: int, k: int = 10) -> set:
    """The data shards that hold the small blocks of needle ``key``."""
    block = encoder.SMALL_BLOCK_SIZE
    off, size = offsets[key]
    end = off + get_actual_size(size, 3)
    return {b % k for b in range(off // block, (end - 1) // block + 1)}


def phase8(state) -> None:
    """The cluster path: the port's master, four port volume servers (CUDA
    backend, ``weed volume`` defaults) and the port shell. A volume of its
    own collection is grown through the master and filled to 512 MiB from 8
    client threads, every fid from ``/dir/assign``. ``ec.encode`` seals it,
    generates on the card and spreads the shards 4/4/3/3. The server with
    shards 1, 5, 9, 13 stops; 64 degraded GETs (a block on a lost data
    shard) and 64 healthy remote GETs go through ``/dir/lookup`` as a
    client's do. ``ec.rebuild`` copies survivors in over HTTP and rebuilds
    the 4 lost shards on the card. Then the server with shards 3, 7, 11
    stops too, and ``ec.decode`` collects the 11 live shards and rebuilds
    data shards 3 and 7 on the card in ``to_volume``. A seeded 1 024 needles
    are read back through the master, and the decoded .dat must hash as the
    original did."""
    col, k, threads, n_servers = "cluster8", 10, 8, 4
    out: dict = {"phase": 8, "servers": n_servers, "collection": col}
    steps: dict = {}
    master = MasterServer(host="127.0.0.1", port=_free_port(), node_timeout=3.0).start()
    servers, dirs, stopped = [], {}, set()
    for i in range(n_servers):
        d = os.path.join(WORK, f"8srv{i}")
        vs = VolumeServer([d], host="127.0.0.1", port=_free_port(), master_url=master.url,
                          pulse_seconds=0.5, ec_backend=EC_BACKEND)
        servers.append(vs)
        dirs[f"127.0.0.1:{vs.port}"] = d
    by_url = {f"127.0.0.1:{vs.port}": vs for vs in servers}
    env = CommandEnv(master.url)
    eng = _Engines(8, servers)

    def step(name: str, fn):
        l0, t0 = gm.gf_matmul.launches, time.perf_counter()
        res = fn()
        steps[name] = {"s": time.perf_counter() - t0, "launches": gm.gf_matmul.launches - l0}
        return res

    def stop_server(url: str) -> None:
        eng.stop(by_url[url])
        stopped.add(url)

        def dropped() -> bool:
            held = master.master.lookup_ec_volume(vid)["shard_id_locations"]
            return not any(url in urls for urls in held.values())
        t0 = time.perf_counter()
        if not _until(dropped, timeout=60):
            raise SystemExit(f"phase 8: the master still names {url} as a shard holder")
        out.setdefault("reaped_after_s", []).append(time.perf_counter() - t0)

    def get(fid: str) -> tuple[int, bytes, float, str]:
        return _client_get(master.url, fid)

    try:
        for vs in servers:
            vs.start()
        eng.check()
        if not _until(lambda: len(master.master.topo.data_nodes()) == n_servers):
            raise SystemExit("phase 8: the volume servers did not register")
        grown = _admin(master.url, f"/vol/grow?collection={col}&count=1&replication=000")
        if grown != {"count": 1}:
            raise SystemExit(f"phase 8: /vol/grow answered {grown}")

        # needles of log-uniform sizes in 1 KiB..1 MiB until the .dat holds
        # 512 MiB; each upload asks the master for its fid, as weed upload does
        blobs = _needle_blobs(8)
        fids, assign_ms, post_ms, write_s, errors = _upload_via_master(
            master.url, col, blobs, threads)
        if errors:
            raise SystemExit(f"phase 8: uploads failed: {errors[:5]}")
        vids = {FileId.parse(f).volume_id for f in fids}
        if len(vids) != 1:
            raise SystemExit(f"phase 8: the assigns spread over volumes {sorted(vids)}")
        vid = vids.pop()
        source = env.volume_locations(vid)[0]
        base = volume_file_name(dirs[source], col, vid)
        a_ms = [x for xs in assign_ms for x in xs]
        p_ms = [x for xs in post_ms for x in xs]
        payload = sum(len(b) for b in blobs)
        out.update(needles=len(blobs), payload_bytes=payload, write_s=write_s,
                   write_MBps=payload / write_s / 1e6, client_threads=threads,
                   assign_ms_p50=_pct(a_ms, 50), assign_ms_p99=_pct(a_ms, 99),
                   master_assign=master.assign_hist.summary(op="assign"),
                   post_ms_p50=_pct(p_ms, 50), post_ms_p99=_pct(p_ms, 99))
        dat_sha, dat_bytes = _sha256(base + ".dat"), os.path.getsize(base + ".dat")
        with open(base + ".idx", "rb") as f:
            offsets = {key: (off, size) for key, off, size in
                       idx_mod.iter_index_file(io.BytesIO(f.read()))}
        out.update(dat_bytes=dat_bytes)

        # ec.encode: readonly, generate on the source's card, copy the
        # shards to the other three, mount, drop the plain volume
        with _ShellCalls() as sc:
            enc = step("ec_encode", lambda: run_command(
                env, f"ec.encode -volumeId={vid} -collection={col}"))
        spread = enc["spread"]
        copied = sum(os.path.getsize(volume_file_name(dirs[t], col, vid) + shard_ext(sid))
                     for t, sids in spread.items() if t != source for sid in sids)
        out["encode"] = {"source": source, "spread": spread,
                         "generate_s": sc.seconds["/admin/ec/generate"],
                         "copy_s": sc.seconds["/admin/ec/copy"], "copied_bytes": copied,
                         "copy_MBps": copied / max(sc.seconds["/admin/ec/copy"], 1e-9) / 1e6,
                         "calls": dict(sc.calls)}
        shape = sorted(len(s) for s in spread.values())
        if shape != [3, 3, 4, 4] or spread[source] != [0, 4, 8, 12]:
            raise SystemExit(f"phase 8: the shards spread as {spread}")
        if not _until(lambda: len(env.ec_shard_locations(vid)) == 14
                      and not master.master.topo.lookup("", vid)):
            raise SystemExit("phase 8: the master never saw all 14 shards")
        bad, sums = check_shards_spread(dirs, spread, col, vid)
        out["encode"]["shard_mismatches"] = bad
        if bad:
            raise SystemExit("phase 8: the spread shards differ from the .vif sums")

        # a server is lost: the one with shards 1, 5, 9, 13 (k=10 survive)
        victim = next(t for t, sids in spread.items() if sids == [1, 5, 9, 13])
        stop_server(victim)
        order = [int(i) for i in np.random.default_rng(88).permutation(len(fids))]
        held = [_shards_of(offsets, FileId.parse(fids[i]).key) for i in range(len(fids))]
        # the server a client's lookup names first answers every read
        answerer = json.loads(_call(master.url, "GET", f"/dir/lookup?volumeId={vid}")[1])[
            "locations"][0]["url"]
        # degraded: a block on a lost data shard; healthy remote: every block
        # on a live shard of another server than the one that answers
        picks = [i for i in order if held[i] & {1, 5, 9}][:64]
        far = {s for t, sids in spread.items() if t not in (answerer, victim) for s in sids}
        healthy = [i for i in order if held[i] <= far][:64]
        out["answerer"] = answerer
        live = [vs.store for url, vs in by_url.items() if url not in stopped]
        for name, picked in (("degraded_get", picks), ("healthy_remote_get", healthy)):
            ms, bad_reads, answered = [], 0, collections.Counter()
            l0 = gm.gf_matmul.launches
            with contextlib.ExitStack() as stack:  # every live server's read path
                rts = [stack.enter_context(_Timed(
                    (st, "_remote_shard_read"), (st, "remote_shard_reader"),
                    (st.ec_codec, "reconstruct"))) for st in live]
                for i in picked:
                    status, data, sec, loc = get(fids[i])
                    ms.append(sec * 1e3)
                    answered[loc] += 1
                    bad_reads += status != 200 or data != blobs[i]

            def total(attr: str, what: str = "seconds") -> float:
                return sum(getattr(rt[attr], what) for rt in rts)
            fetch_s, attempt_s = total("_remote_shard_read"), total("remote_shard_reader")
            steps[name] = {"s": sum(ms) / 1e3, "launches": gm.gf_matmul.launches - l0}
            out[name] = {"reads": len(picked), "bad_reads": bad_reads,
                         "answered_by": dict(answered),
                         "ms_p50": _pct(ms, 50), "ms_p99": _pct(ms, 99),
                         "remote_fetch_s": fetch_s,
                         "remote_fetch_calls": total("_remote_shard_read", "calls"),
                         "remote_attempt_s": attempt_s,
                         "remote_attempts": total("remote_shard_reader", "calls"),
                         "retry_backoff_s": fetch_s - attempt_s,
                         "reconstruct_s": total("reconstruct"),
                         "reconstruct_calls": total("reconstruct", "calls")}
            if bad_reads or len(picked) < 64:
                raise SystemExit(f"phase 8: {bad_reads} of {len(picked)} {name} reads wrong")
        if steps["healthy_remote_get"]["launches"]:
            raise SystemExit("phase 8: a healthy remote read ran the kernel")

        # ec.rebuild: the rebuilder copies survivors in, rebuilds the 4 lost
        with _ShellCalls() as sc:
            reb = step("ec_rebuild", lambda: run_command(
                env, f"ec.rebuild -volumeId={vid} -collection={col}"))
        rebuilder = reb["rebuilder"]
        rbase = volume_file_name(dirs[rebuilder], col, vid)
        bad_sums = [s for s in reb["rebuilt"] if _sha256(rbase + shard_ext(s)) != sums[s]]
        out["rebuild"] = {"rebuilder": rebuilder, "rebuilt": reb["rebuilt"],
                          "copy_in_s": sc.seconds["/admin/ec/copy"],
                          "copy_in_shards": sc.calls["/admin/ec/copy"],
                          "kernel_step_s": sc.seconds["/admin/ec/rebuild"],
                          "bad_shard_sums": bad_sums}
        if reb["rebuilt"] != [1, 5, 9, 13] or bad_sums:
            raise SystemExit(f"phase 8: rebuild gave {reb}, bad sums {bad_sums}")
        if not _until(lambda: len(env.ec_shard_locations(vid)) == 14):
            raise SystemExit("phase 8: the rebuilt shards never registered")

        # a second server is lost: ec.decode collects the 11 live shards and
        # rebuilds the missing data shards in to_volume
        second = next(t for t, sids in spread.items() if sids == [3, 7, 11])
        stop_server(second)
        with _ShellCalls() as sc:
            dec = step("ec_decode", lambda: run_command(
                env, f"ec.decode -volumeId={vid} -collection={col}"))
        target = dec["decoded_on"]
        tbase = volume_file_name(dirs[target], col, vid)
        dat_ok = _sha256(tbase + ".dat") == dat_sha and dec["dat_size"] == dat_bytes
        out["decode"] = {"target": target, "collected": dec["collected_shards"],
                         "collect_s": sc.seconds["/admin/ec/copy"],
                         "to_volume_s": sc.seconds["/admin/ec/to_volume"],
                         "dat_identical": dat_ok, "file_count": dec["file_count"],
                         "retire_errors": dec.get("retire_errors", [])}
        if not dat_ok or dec["file_count"] != len(blobs):
            raise SystemExit(f"phase 8: the decoded volume differs: {out['decode']}")
        if not _until(lambda: master.master.lookup_volume(vid)
                      and not env.ec_shard_locations(vid)):
            raise SystemExit("phase 8: the decoded volume never replaced the EC one")

        # a seeded sample of the needles back through the master, 8 client
        # threads (every needle before PR 16's cut)
        bad_back: list = []

        def read_back(i: int) -> None:
            status, data, _, _ = get(fids[i])
            if status != 200 or data != blobs[i]:
                bad_back.append(fids[i])

        back = _sample(list(range(len(blobs))), READ_BACK_SAMPLE, 808)
        out.update(read_back_s=_parallel(read_back, back, threads), read_back_needles=len(back),
                   read_back_bad=len(bad_back))
        if bad_back:
            raise SystemExit(f"phase 8: {len(bad_back)} needles read back wrong: {bad_back[:5]}")
    finally:
        for url, vs in by_url.items():
            if url not in stopped:
                eng.stop(vs)
        master.stop()
    out.update(turbo=eng.totals(), steps=steps,
               launches=gm.gf_matmul.launches - state["l_phase"], nvidia_smi=state["smi"])
    emit(out)
    idle = [name for name in ("ec_encode", "degraded_get", "ec_rebuild", "ec_decode")
            if not steps[name]["launches"]]
    if idle:
        raise SystemExit(f"phase 8: no kernel launch in {idle}")


def check_shards_spread(dirs: dict, spread: dict, col: str, vid: int) -> tuple[int, list]:
    """Each spread shard's sha256 on its holder against the sums the .vif
    records at generate: (bad count, the sums by shard id). The parity's
    bytes are held to the data end to end: the degraded reads, the rebuild
    and the decode all reconstruct data shards from it. (The source drops
    its .vif with the plain volume, as the reference's does; the copies
    carry it.)"""
    vif = next(p for p in (volume_file_name(d, col, vid) + ".vif" for d in dirs.values())
               if os.path.exists(p))
    with open(vif) as f:
        sums = json.load(f)["shard_sums"]
    bad = sum(_sha256(volume_file_name(dirs[t], col, vid) + shard_ext(s)) != sums[s]
              for t, sids in spread.items() for s in sids)
    return bad, sums


# -- phase 9: an operator's maintenance cycle ------------------------------------
SCRUB_RATE = 1024  # needles a second a volume (the reference's default is 32)


class _IdxSizes:
    """Within the block, every ``index_file_size`` a needle map answers is
    recorded: a compaction asks once at its snapshot and once before it
    replays what landed meanwhile under the lock."""

    def __enter__(self):
        self.sizes: list = []
        self.saved = IdxLogMixin.index_file_size

        def record(nm, saved=self.saved):
            size = saved(nm)
            self.sizes.append(size)
            return size

        IdxLogMixin.index_file_size = record
        return self

    def __exit__(self, *exc):
        IdxLogMixin.index_file_size = self.saved


def _flip(path: str, offset: int) -> None:
    """Flip one byte of ``path`` on disk, as a decaying disk would."""
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x5A]))


def phase9(state) -> None:
    """An operator's maintenance cycle on the port's cluster: the master,
    four volume servers (CUDA backend, ``weed volume`` defaults, the scrub on
    with ``SWEED_SCRUB=1``) and the shell, in one process. A volume filled to
    512 MiB as in phase 8 loses ~30 % of its needles, then ``volume.vacuum``
    compacts it while a writer and a deleter keep at it; ``volume.configure
    .replication`` and ``volume.fix.replication`` add a replica; a byte
    flipped in that replica's .dat reaches the master through the scrub, the
    replica is dropped and fixed again; ``volume.move`` and ``volume.balance``
    move replicas; ``backup`` copies the volume, fully and then
    incrementally; ``ec.encode`` seals it on the card; a byte flipped in a
    shard reaches the master through the scrub, the shard is dropped and
    ``ec.rebuild`` makes it again on the card; ``volumeServer.evacuate`` and
    ``volumeServer.leave`` retire a server; a seeded 1 024 needles read back
    through the master (live ones equal, deleted ones 404)."""
    col, threads, n_servers = "maint9", 8, 4
    out: dict = {"phase": 9, "servers": n_servers, "collection": col,
                 "scrub_rate": SCRUB_RATE}
    steps: dict = {}
    saved_env = {k: os.environ.get(k) for k in ("SWEED_SCRUB", "SWEED_SCRUB_RATE")}
    os.environ.update(SWEED_SCRUB="1", SWEED_SCRUB_RATE=str(SCRUB_RATE))
    master = MasterServer(host="127.0.0.1", port=_free_port(), node_timeout=3.0).start()
    servers, dirs = [], {}
    for i in range(n_servers):
        d = os.path.join(WORK, f"9srv{i}")
        vs = VolumeServer([d], host="127.0.0.1", port=_free_port(), master_url=master.url,
                          pulse_seconds=0.5, ec_backend=EC_BACKEND)
        servers.append(vs)
        dirs[f"127.0.0.1:{vs.port}"] = d
    by_url = {f"127.0.0.1:{vs.port}": vs for vs in servers}
    env = CommandEnv(master.url)
    eng = _Engines(9, servers)
    scrub0 = {k: c.total() for k, c in SCRUB_COUNTERS.items()}
    t_start = time.perf_counter()

    def node(url: str):
        return next((dn for dn in master.master.topo.data_nodes() if dn.url() == url), None)

    def shell(name: str, line: str):
        l0, t0 = gm.gf_matmul.launches, time.perf_counter()
        res = run_command(env, line)
        steps[name] = {"s": time.perf_counter() - t0, "launches": gm.gf_matmul.launches - l0}
        return res

    def wait(cond, what: str, timeout: float = 120.0) -> float:
        def holds() -> bool:
            try:
                return bool(cond())
            except (KeyError, AttributeError):  # a node or volume not there yet
                return False

        t0 = time.perf_counter()
        if not _until(holds, timeout=timeout):
            raise SystemExit(f"phase 9: {what}")
        return time.perf_counter() - t0

    def holders() -> list:
        return env.volume_locations(vid)

    def vol_bytes(url: str) -> int:
        base = volume_file_name(dirs[url], col, vid)
        return os.path.getsize(base + ".dat") + os.path.getsize(base + ".idx")

    live: dict = {}
    dead: set = set()
    lock = threading.Lock()

    def read_back(fetch, what: str, sample: bool = False) -> float:
        """Every live needle equal and every deleted one 404 (with
        ``sample``, a seeded ``READ_BACK_SAMPLE`` of them), from 8 threads."""
        bad: list = []

        def one(item) -> None:
            fid, want = item
            status, data = fetch(fid)
            ok = status == 404 if want is None else (status, data) == (200, want)
            if not ok:
                bad.append((fid, status))

        items = list(live.items()) + [(f, None) for f in sorted(dead)]
        if sample:
            items = _sample(items, READ_BACK_SAMPLE, 909)
        s = _parallel(one, items, threads)
        if bad:
            raise SystemExit(f"phase 9: {len(bad)} needles wrong {what}: {bad[:5]}")
        return s

    try:
        for vs in servers:
            vs.start()
        eng.check()
        wait(lambda: len(master.master.topo.data_nodes()) == n_servers,
             "the volume servers did not register", 30)
        grown = _admin(master.url, f"/vol/grow?collection={col}&count=1&replication=000")
        if grown != {"count": 1}:
            raise SystemExit(f"phase 9: /vol/grow answered {grown}")

        # 1. fill volume A to 512 MiB, then delete a seeded ~30 % of it
        blobs = _needle_blobs(9)
        fids, assign_ms, post_ms, write_s, errors = _upload_via_master(
            master.url, col, blobs, threads)
        if errors:
            raise SystemExit(f"phase 9: uploads failed: {errors[:5]}")
        vids = {FileId.parse(f).volume_id for f in fids}
        if len(vids) != 1:
            raise SystemExit(f"phase 9: the assigns spread over volumes {sorted(vids)}")
        vid = vids.pop()
        source = holders()[0]
        live.update(zip(fids, blobs))
        payload = sum(len(b) for b in blobs)
        out["upload"] = {"needles": len(blobs), "payload_bytes": payload, "write_s": write_s,
                         "write_MBps": payload / write_s / 1e6}
        # keys for the writes during the vacuum and for the backup's needles
        a = json.loads(_call(master.url, "GET", f"/dir/assign?collection={col}&count=400")[1])
        new = FileId.parse(a["fid"])
        if new.volume_id != vid:
            raise SystemExit(f"phase 9: the batch assign went to volume {new.volume_id}")
        new_fids = [str(FileId(vid, new.key + i, 0x9000 + i)) for i in range(400)]
        rng = np.random.default_rng(90)
        order = [fids[i] for i in rng.permutation(len(fids))]
        doomed, later = order[:len(fids) * 3 // 10], order[len(fids) * 3 // 10:]
        failed: list = []

        def delete(fid: str) -> None:
            status, _, _ = _call(source, "DELETE", "/" + fid)
            if status != 202:
                failed.append((fid, status))

        out["delete_s"] = _parallel(delete, doomed, threads)
        if failed:
            raise SystemExit(f"phase 9: deletes failed: {failed[:5]}")
        for fid in doomed:
            live.pop(fid)
            dead.add(fid)

        # 2. volume.vacuum while a writer and a deleter keep at A
        base = volume_file_name(dirs[source], col, vid)
        ratio = json.loads(_call(source, "GET", f"/admin/vacuum_check?volume={vid}")[1])
        rev0 = json.loads(_call(source, "GET", f"/admin/volume_status?volume={vid}")[1])[
            "compaction_revision"]
        dat_before = os.path.getsize(base + ".dat")
        v = by_url[source].store.find_volume(vid)
        done = threading.Event()
        during = collections.Counter()

        def writer() -> None:
            wrng = np.random.default_rng(91)
            for i in range(300):
                if done.is_set() and i >= 200:
                    return
                data = wrng.bytes(int(wrng.integers(1024, 16 * 1024)))
                status, _, _ = _call(source, "POST", "/" + new_fids[i], data)
                if status != 201:
                    failed.append((new_fids[i], status))
                    return
                with lock:
                    live[new_fids[i]] = data
                during["writes"] += 1
                during["writes_compacting"] += v._is_compacting

        def deleter() -> None:
            for i, fid in enumerate(later[:150]):
                if done.is_set() and i >= 50:
                    return
                status, _, _ = _call(source, "DELETE", "/" + fid)
                if status != 202:
                    failed.append((fid, status))
                    return
                with lock:
                    live.pop(fid)
                    dead.add(fid)
                during["deletes"] += 1
                during["deletes_compacting"] += v._is_compacting

        workers = [threading.Thread(target=writer), threading.Thread(target=deleter)]
        with _IdxSizes() as idx, _Timed((v, "compact")) as ct:
            for t in workers:
                t.start()
            try:
                compacted = shell("vacuum", "volume.vacuum -garbageThreshold=0.25")
            finally:
                done.set()
                for t in workers:
                    t.join()
        if failed:
            raise SystemExit(f"phase 9: writes or deletes beside the vacuum failed: {failed[:5]}")
        if v.turbo is None or by_url[source].store.find_volume(vid) is not v:
            raise SystemExit("phase 9: the engine did not take the compacted volume back")
        dat_after = os.path.getsize(base + ".dat")
        rev1 = json.loads(_call(source, "GET", f"/admin/volume_status?volume={vid}")[1])[
            "compaction_revision"]
        entry = 16  # .idx entry bytes (8 key + 4 offset + 4 size)
        out["vacuum"] = {
            "garbage_ratio_before": ratio["garbage_ratio"], "dat_bytes_before": dat_before,
            "dat_bytes_after": dat_after, "compact_s": ct["compact"].seconds,
            "live_MBps": dat_after / ct["compact"].seconds / 1e6,
            "entries_replayed": (idx.sizes[1] - idx.sizes[0]) // entry if len(idx.sizes) >= 2
            else None, "compacted": compacted, "revision": [rev0, rev1],
            "engine_reattached": v.turbo is not None, **during}
        if compacted != [vid] or dat_after >= dat_before or rev1 != (rev0 + 1) & 0xFFFF:
            raise SystemExit(f"phase 9: the vacuum did not compact A: {out['vacuum']}")
        if during["writes"] < 200 or during["deletes"] < 50 or not (
                during["writes_compacting"] + during["deletes_compacting"]):
            raise SystemExit(f"phase 9: too few writes or deletes beside the vacuum: {during}")
        wait(lambda: node(source).volumes[vid].compact_revision == rev1,
             "the master never saw the new compaction revision")
        out["vacuum"]["read_back_s"] = read_back(
            lambda fid: _call(source, "GET", "/" + fid)[:2], "after the vacuum")

        # 3. a second replica: configure the placement, then fix it
        shell("configure", f"volume.configure.replication -volumeId={vid} -replication=001")
        wait(lambda: node(source).volumes[vid].replica_placement.to_byte() == 1,
             "the master never saw the new placement")
        with _ShellCalls() as sc:
            fix = shell("fix_replication", "volume.fix.replication")
        if len(fix["fixed"]) != 1:
            raise SystemExit(f"phase 9: volume.fix.replication answered {fix}")
        copy = fix["fixed"][0]["to"]
        out["fix_replication"] = {"to": copy, "s": sc.seconds["/admin/volume_copy"],
                                  "bytes": vol_bytes(copy),
                                  "MBps": vol_bytes(copy) / sc.seconds["/admin/volume_copy"] / 1e6}
        wait(lambda: sorted(holders()) == sorted([source, copy]),
             "the master never named the new replica")

        # 4. a byte of a needle decays in the replica: the scrub tells the
        # master; the operator drops the replica and fixes the placement again
        cv = by_url[copy].store.find_volume(vid)
        first = min((nv for nv in cv.nm.items() if nv.size > 0), key=lambda nv: nv.offset)
        _flip(volume_file_name(dirs[copy], col, vid) + ".dat", first.offset + 16 + 4 + 3)
        scrub_needle_s = wait(lambda: node(copy).volumes[vid].corrupt_needles >= 1,
                              "the scrub never reported the flipped needle", 300)
        _admin(copy, f"/admin/delete_volume?volume={vid}")
        wait(lambda: holders() == [source], "the master still names the dropped replica")
        with _ShellCalls() as sc:
            fix2 = shell("fix_replication_again", "volume.fix.replication")
        if len(fix2["fixed"]) != 1:
            raise SystemExit(f"phase 9: the second volume.fix.replication answered {fix2}")
        copy = fix2["fixed"][0]["to"]
        out["fix_replication_again"] = {
            "to": copy, "s": sc.seconds["/admin/volume_copy"], "bytes": vol_bytes(copy),
            "MBps": vol_bytes(copy) / sc.seconds["/admin/volume_copy"] / 1e6}
        wait(lambda: sorted(holders()) == sorted([source, copy]) and all(
            node(u).volumes[vid].corrupt_needles == 0 for u in holders()),
            "the corrupt needle count never returned to 0")

        # 5. move the replica, then balance (four empty volumes give it work)
        target = next(u for u in sorted(by_url) if u not in (source, copy))
        with _ShellCalls() as sc:
            shell("move", f"volume.move -volumeId={vid} -source={copy} -target={target}")
        out["move"] = {"from": copy, "to": target, "s": sc.seconds["/admin/volume_copy"],
                       "bytes": vol_bytes(target),
                       "MBps": vol_bytes(target) / sc.seconds["/admin/volume_copy"] / 1e6}
        wait(lambda: sorted(holders()) == sorted([source, target]), "the move never registered")
        if _admin(master.url, f"/vol/grow?collection={col}b&count=4") != {"count": 4}:
            raise SystemExit("phase 9: the empty volumes did not grow")
        wait(lambda: len(shell_commands.volume_list(env)) == 6, "the empty volumes never showed")
        bal = shell("balance", "volume.balance -force=true")
        out["balance"] = {"plan": bal["plan"], "moved": len(bal["moved"]),
                          "skipped": bal["skipped"], "s": steps["balance"]["s"]}
        wait(lambda: len(holders()) == 2, "the balance left A without its two replicas")

        # 6. backup: a full pass, 100 more needles, an incremental pass
        bdir = os.path.join(WORK, "9backup")

        def backup() -> tuple[str, float]:
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "seaweedfs_tpu_torch", "backup", "-master", master.url,
                 "-volume", str(vid), "-dir", bdir, "-collection", col],
                cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE), capture_output=True,
                text=True, timeout=600)
            if r.returncode != 0:
                raise SystemExit(f"phase 9: backup failed: {r.stdout} {r.stderr[-2000:]}")
            return r.stdout.strip(), time.perf_counter() - t0

        full, full_s = backup()
        full_bytes = os.path.getsize(volume_file_name(bdir, col, vid) + ".dat")
        primary = holders()[0]
        brng = np.random.default_rng(92)
        for fid in new_fids[300:]:
            data = brng.bytes(int(brng.integers(1024, 64 * 1024)))
            status, _, _ = _call(primary, "POST", "/" + fid, data)
            if status != 201:
                raise SystemExit(f"phase 9: the backup's extra needle {fid} answered {status}")
            live[fid] = data
        incr, incr_s = backup()
        local = volume_file_name(bdir, col, vid) + ".dat"
        same = _sha256(local) == _sha256(volume_file_name(dirs[holders()[0]], col, vid) + ".dat")
        incr_bytes = os.path.getsize(local) - full_bytes
        out["backup"] = {"full": full, "full_s": full_s, "full_MBps": full_bytes / full_s / 1e6,
                         "incremental": incr, "incremental_s": incr_s,
                         "incremental_MBps": incr_bytes / incr_s / 1e6, "identical": same}
        if not same or "+100 writes" not in incr:
            raise SystemExit(f"phase 9: the backup differs from the server's: {out['backup']}")

        # 7. seal A: ec.encode generates on the card and spreads 4/4/3/3
        source = holders()[0]
        check = os.path.join(WORK, "9check")
        os.makedirs(check)
        cbase = volume_file_name(check, col, vid)
        os.link(volume_file_name(dirs[source], col, vid) + ".dat", cbase + ".dat")
        with _ShellCalls() as sc:
            enc = shell("ec_encode", f"ec.encode -volumeId={vid} -collection={col}")
        spread = enc["spread"]
        out["ec_encode"] = {"source": source, "spread": spread,
                            "generate_s": sc.seconds["/admin/ec/generate"],
                            "spread_s": sc.seconds["/admin/ec/copy"],
                            "launches": steps["ec_encode"]["launches"]}
        if sorted(len(s) for s in spread.values()) != [3, 3, 4, 4]:
            raise SystemExit(f"phase 9: the shards spread as {spread}")
        wait(lambda: len(env.ec_shard_locations(vid)) == 14
             and not master.master.topo.lookup("", vid),
             "the master never saw all 14 shards in place of the plain volume", 60)
        for t, sids in spread.items():
            for sid in sids:
                os.link(volume_file_name(dirs[t], col, vid) + shard_ext(sid),
                        cbase + shard_ext(sid))
        # the .vif came with each spread copy, but a server that held a plain
        # replica lost it when ec.encode deleted that replica (as the source
        # does, ROADMAP Queue C)
        copier = next((t for t in sorted(spread) if os.path.exists(
            volume_file_name(dirs[t], col, vid) + ".vif")), None)
        if copier is None:
            raise SystemExit("phase 9: no server kept the .vif")
        shutil.copy(volume_file_name(dirs[copier], col, vid) + ".vif", cbase + ".vif")
        bad, sums = check_shards(cbase, by_url[source].store.ec_codec)
        out["ec_encode"]["shard_mismatches"] = bad
        if bad:
            raise SystemExit("phase 9: the shards differ from the plain codec's")

        # 8. a byte of a shard decays on a server that holds the .vif: the
        # scrub tells the master; the shard is dropped and rebuilt
        sid = spread[copier][0]
        _flip(volume_file_name(dirs[copier], col, vid) + shard_ext(sid), 4321)
        scrub_shard_s = wait(lambda: sid in node(copier).ec_corrupt.get(vid, []),
                             "the scrub never reported the flipped shard", 300)
        _admin(copier, f"/admin/ec/delete_shards?volume={vid}&shards={sid}")
        wait(lambda: sid not in env.ec_shard_locations(vid), "the dropped shard stayed")
        with _ShellCalls() as sc:
            reb = shell("ec_rebuild", f"ec.rebuild -volumeId={vid} -collection={col}")
        rebuilt_sha = _sha256(volume_file_name(dirs[reb["rebuilder"]], col, vid)
                              + shard_ext(sid))
        out["ec_rebuild"] = {"shard": sid, "rebuilder": reb["rebuilder"],
                             "rebuilt": reb["rebuilt"], "s": steps["ec_rebuild"]["s"],
                             "kernel_step_s": sc.seconds["/admin/ec/rebuild"],
                             "launches": steps["ec_rebuild"]["launches"],
                             "sum_equal": rebuilt_sha == sums[sid]}
        if reb["rebuilt"] != [sid] or rebuilt_sha != sums[sid]:
            raise SystemExit(f"phase 9: the rebuild gave {out['ec_rebuild']}")
        wait(lambda: len(env.ec_shard_locations(vid)) == 14 and not any(
            dn.ec_corrupt.get(vid) for dn in master.master.topo.data_nodes()),
            "the master's corrupt shard never cleared")
        out["scrub"] = {"needle_to_master_s": scrub_needle_s,
                        "shard_to_master_s": scrub_shard_s}

        # 9. retire a server: evacuate its shards and volumes, then leave
        evacuee = next(u for u in sorted(by_url, reverse=True) if u != source)
        ev = shell("evacuate", f"volumeServer.evacuate -node={evacuee}")
        wait(lambda: len(env.ec_shard_locations(vid)) == 14 and not any(
            evacuee in us for us in env.ec_shard_locations(vid).values()),
            "the evacuated shards never registered elsewhere")
        t0 = time.perf_counter()
        shell("leave", f"volumeServer.leave -node={evacuee}")
        wait(lambda: node(evacuee) is None, "the master kept the server that left", 30)
        leave_s = time.perf_counter() - t0
        out["retire"] = {"evacuee": evacuee, "evacuate": ev, "evacuate_s": steps["evacuate"]["s"],
                         "leave_s": leave_s}
        if leave_s >= master.node_timeout:
            raise SystemExit(f"phase 9: the master took {leave_s:.2f} s to drop the server")

        # 10. a seeded sample of A's needles back through the master (every
        # one before PR 16's cut)
        out["read_back"] = {"needles": len(live), "deleted": len(dead),
                            "sampled": min(READ_BACK_SAMPLE, len(live) + len(dead)),
                            "s": read_back(lambda fid: _client_get(master.url, fid)[:2],
                                           "through the master", sample=True), "wrong": 0}
    finally:
        for vs in servers:
            eng.stop(vs)
        master.stop()
        for k, val in saved_env.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
    wall = time.perf_counter() - t_start
    scrubbed = SCRUB_COUNTERS["bytes"].total() - scrub0["bytes"]
    out["scrub"].update(bytes=scrubbed, MBps=scrubbed / wall / 1e6,
                        crc_errors=SCRUB_COUNTERS["errors"].total() - scrub0["errors"])
    out.update(turbo=eng.totals(), steps=steps,
               launches=gm.gf_matmul.launches - state["l_phase"], nvidia_smi=state["smi"])
    emit(out)
    idle = [name for name in ("ec_encode", "ec_rebuild") if not steps[name]["launches"]]
    if idle:
        raise SystemExit(f"phase 9: no kernel launch in {idle}")


# -- phase 10: weed benchmark on the default data plane ------------------------
# weed/command/benchmark.go's defaults (-c 16 -size 1024) with the reference's
# -assign.batch 100, at half its -n 1048576 (a cut since phase 11 came, so
# that the whole script stays well inside its time limit: PERF.md section 4)
BENCH_N, BENCH_C, BENCH_SIZE, BENCH_BATCH = 1 << 17, 16, 1024, 100  # cuts: PERF.md section 4
BENCH_N_THREADS = 1 << 12  # the run on the asyncio core alone (cuts: PERF.md section 4)
BENCH_SAMPLE = 4096  # fids read back and compared after the run
SHED_WATERMARK, SHED_CONNS = 64, 512
EC_READS = 2048  # fids of the sealed volume read back through the engine (cuts: PERF.md 4)


def _bench_summary(run: dict, kind: str) -> dict:
    ms = [x * 1e3 for x in run[kind]["latencies"]]
    wall = run[kind]["wall"]
    return {"requests": len(ms), "failures": run[kind]["failures"], "wall_s": wall,
            "req_per_s": len(ms) / wall, "ms_p50": _pct(ms, 50), "ms_p99": _pct(ms, 99)}


def _read_all(url: str, items: list, threads: int) -> tuple[list, list]:
    """GET every (fid, body) of ``items`` from ``url`` on ``threads``
    keep-alive connections: (wrong fids, ms per GET)."""
    nxt = iter(items)
    bad, ms = [], []
    lock = threading.Lock()

    def work() -> None:
        conn = http.client.HTTPConnection(url, timeout=600)
        try:
            for fid, want in nxt:  # a shared iterator: each item goes to one thread
                t0 = time.perf_counter()
                conn.request("GET", "/" + fid)
                resp = conn.getresponse()
                data = resp.read()
                with lock:
                    ms.append((time.perf_counter() - t0) * 1e3)
                    if resp.status != 200 or data != want:
                        bad.append((fid, resp.status))
        finally:
            conn.close()

    pool = [threading.Thread(target=work) for _ in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    return bad, ms


def _storm(port: int, n: int) -> collections.Counter:
    """``n`` connections opened at once, one GET each: their answers by
    status, and how many 503s carried a Retry-After."""
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.settimeout(30)
        s.connect(("127.0.0.1", port))
        socks.append(s)
    got: collections.Counter = collections.Counter()
    req = b"GET /status HTTP/1.1\r\nHost: t\r\nContent-Length: 0\r\n\r\n"
    for s in socks:
        try:
            s.sendall(req)
        except OSError:
            pass  # shed at accept: the 503 is already in the buffer
    for s in socks:
        buf = b""
        try:
            while b"\r\n\r\n" not in buf:
                chunk = s.recv(65536)
                if not chunk:
                    break
                buf += chunk
        except OSError:
            pass
        finally:
            s.close()
        if not buf.startswith(b"HTTP/1.1 "):
            got["no_reply"] += 1
            continue
        status = int(buf[9:12])
        got[status] += 1
        if status == 503 and b"\r\nRetry-After: " in buf.split(b"\r\n\r\n")[0]:
            got["503_retry_after"] += 1
    return got


def phase10(state) -> None:
    """``weed benchmark`` on the default data plane, then EC through the
    engine: the port's master and one port volume server on ``weed
    master``/``weed volume`` defaults, in one process as the reference's
    small-file probe runs them."""
    out: dict = {"phase": 10, "n": BENCH_N, "c": BENCH_C, "size": BENCH_SIZE,
                 "assign_batch": BENCH_BATCH}
    # the storm holds SHED_CONNS client sockets and as many accepted ones
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft != resource.RLIM_INFINITY and soft < 8192:
        resource.setrlimit(resource.RLIMIT_NOFILE, (
            8192 if hard == resource.RLIM_INFINITY else min(8192, hard), hard))
    master = MasterServer(host="127.0.0.1", port=_free_port()).start()
    d = os.path.join(WORK, "10srv")
    port = _free_port()
    url = f"127.0.0.1:{port}"
    env = CommandEnv(master.url)

    def server():
        vs = VolumeServer([d], host="127.0.0.1", port=port, master_url=master.url,
                          ec_backend=EC_BACKEND).start()
        if not _until(lambda: any(dn.url() == url for dn in master.master.topo.data_nodes())):
            raise SystemExit("phase 10: the volume server did not register")
        return vs

    expected: dict = {}  # fid -> body, every needle written in the phase
    vs = server()
    eng = _Engines(10, [vs])
    try:
        # a. the benchmark under the defaults
        eng.check()
        c0 = vs.turbo.counters()
        run = run_benchmark(master.url, BENCH_N, BENCH_C, BENCH_SIZE, assign_batch=BENCH_BATCH)
        c1 = vs.turbo.counters()
        delta = {k: c1[k] - c0[k] for k in c1}
        a = {"write": _bench_summary(run, "write"), "read": _bench_summary(run, "read"),
             "turbo": delta}
        for fid, _ in run["fids"]:
            expected[fid] = run["payload"]
        sample = [run["fids"][int(i)][0] for i in
                  np.random.default_rng(10).choice(len(run["fids"]), BENCH_SAMPLE, replace=False)]
        bad, _ = _read_all(url, [(f, run["payload"]) for f in sample], 8)
        a["sample_read_back"], a["sample_wrong"] = len(sample), len(bad)
        out["benchmark"] = a
        if a["write"]["failures"] or a["read"]["failures"] or bad or \
                a["write"]["requests"] != BENCH_N or a["read"]["requests"] != BENCH_N:
            raise SystemExit(f"phase 10: the benchmark failed: {a}, wrong {bad[:5]}")
        if delta["posts"] < BENCH_N or delta["gets"] < BENCH_N or \
                delta["proxied"] > BENCH_N // 100:
            raise SystemExit(f"phase 10: the engine did not serve the run: {delta}")
        eng.stop(vs)

        # b. the same server on the asyncio core alone
        os.environ["SWEED_TURBO"] = "0"
        try:
            vs = server()
            if vs.turbo is not None or vs.turbo_status()["reason"] != "SWEED_TURBO=0":
                raise SystemExit("phase 10: SWEED_TURBO=0 did not keep the engine out")
            s0 = SERVING.snapshot()
            run_b = run_benchmark(master.url, BENCH_N_THREADS, BENCH_C, BENCH_SIZE,
                                  assign_batch=BENCH_BATCH)
            s1 = SERVING.snapshot()
            b = {"write": _bench_summary(run_b, "write"), "read": _bench_summary(run_b, "read"),
                 "native_hits": s1["native_hits"] - s0["native_hits"],
                 "native_fallbacks": s1["native_fallbacks"] - s0["native_fallbacks"]}
            for fid, _ in run_b["fids"]:
                expected[fid] = run_b["payload"]
            # 1 KiB needles sit under the sendfile floor: the native route
            # takes every read on the loop and hands it to the bridged path
            if b["write"]["failures"] or b["read"]["failures"] or \
                    b["native_hits"] + b["native_fallbacks"] < BENCH_N_THREADS:
                raise SystemExit(f"phase 10: the asyncio-core run failed: {b}")
            # needles above the sendfile floor go out by sendfile on the loop
            asg = json.loads(_call(master.url, "GET", "/dir/assign?count=64&collection=benchmark")[1])
            big_rng = np.random.default_rng(101)
            bigs = []
            for i in range(64):
                fid = asg["fid"] if i == 0 else f"{asg['fid']}_{i}"
                body = big_rng.bytes(256 * 1024)
                status, _, _ = _call(asg["url"], "POST", "/" + fid, body)
                if status != 201:
                    raise SystemExit(f"phase 10: the 256 KiB upload {fid} answered {status}")
                bigs.append((fid, body))
                expected[fid] = body
            h0 = SERVING.snapshot()["native_hits"]
            bad, ms = _read_all(url, bigs, 4)
            # the loop counts a native reply once its last byte is queued,
            # which can come after the client has read it
            _until(lambda: SERVING.snapshot()["native_hits"] - h0 >= len(bigs), 5)
            b["sendfile_gets"] = {"reads": len(bigs), "wrong": len(bad),
                                  "native_hits": SERVING.snapshot()["native_hits"] - h0,
                                  "ms_p50": _pct(ms, 50), "ms_p99": _pct(ms, 99)}
            if bad or b["sendfile_gets"]["native_hits"] < len(bigs):
                raise SystemExit(f"phase 10: the sendfile GETs: {b['sendfile_gets']}")
            # a connection storm against a low watermark: shed, then recover
            os.environ["SWEED_MAX_INFLIGHT"] = str(SHED_WATERMARK)
            try:
                r0 = SERVING.snapshot()["admission_rejected"]
                storm = _storm(port, SHED_CONNS)
                shed = SERVING.snapshot()["admission_rejected"] - r0
            finally:
                os.environ.pop("SWEED_MAX_INFLIGHT")
            bad, _ = _read_all(url, bigs, 8)
            b["storm"] = {"connections": SHED_CONNS, "watermark": SHED_WATERMARK,
                          "answers": {str(k): v for k, v in storm.items()},
                          "admission_rejected": shed, "after_gets": len(bigs),
                          "after_wrong": len(bad)}
            if storm[200] + storm[503] != SHED_CONNS or storm[503] < 1 or \
                    storm["503_retry_after"] != storm[503] or bad:
                raise SystemExit(f"phase 10: the storm: {b['storm']}")
            out["asyncio_core"] = b
            vs.stop()
        finally:
            os.environ.pop("SWEED_TURBO", None)

        # c. EC through the engine: seal the fullest benchmark volume
        vs = server()
        eng.servers = [vs]
        eng.check()
        vid = max((v for loc in vs.store.locations for v in loc.volumes.values()
                   if v.collection == "benchmark"), key=lambda v: v.file_count()).id
        fids = [f for f in expected if FileId.parse(f).volume_id == vid]
        src = volume_file_name(d, "benchmark", vid)
        check = os.path.join(WORK, "10check")
        os.makedirs(check)
        cbase = volume_file_name(check, "benchmark", vid)
        os.link(src + ".dat", cbase + ".dat")
        l0, t0 = gm.gf_matmul.launches, time.perf_counter()
        saved = shell_commands.http_json

        def keep_vif(method, target, *args, **kwargs):
            # ec.encode's last step deletes the plain volume and its .vif
            # with it (ROADMAP Queue C): keep a link to the sums first
            res = saved(method, target, *args, **kwargs)
            if urllib.parse.urlsplit(target).path == "/admin/ec/generate":
                os.link(src + ".vif", cbase + ".vif")
            return res

        shell_commands.http_json = keep_vif
        try:
            enc = run_command(env, f"ec.encode -volumeId={vid} -collection=benchmark")
        finally:
            shell_commands.http_json = saved
        c = {"volume": vid, "needles": len(fids), "dat_bytes": os.path.getsize(cbase + ".dat"),
             "encode_s": time.perf_counter() - t0,
             "encode_launches": gm.gf_matmul.launches - l0, "spread": enc["spread"]}
        if not _until(lambda: len(env.ec_shard_locations(vid)) == 14
                      and not master.master.topo.lookup("benchmark", vid), 60):
            raise SystemExit("phase 10: the master never saw the 14 shards")
        for i in range(14):
            os.link(src + shard_ext(i), cbase + shard_ext(i))
        bad_bytes, _ = check_shards(cbase, vs.store.ec_codec)
        c["shard_mismatches"] = bad_bytes
        if bad_bytes:
            raise SystemExit("phase 10: the shards differ from the plain codec's")
        removed = _admin(url, f"/admin/ec/delete_shards?volume={vid}&shards="
                              + ",".join(map(str, LOST)))["removed"]
        if removed != LOST:
            raise SystemExit(f"phase 10: delete_shards removed {removed}")
        picks = [fids[int(i)] for i in np.random.default_rng(102).permutation(len(fids))]
        picks = picks[:EC_READS]
        p0, l0 = vs.turbo.counters()["proxied"], gm.gf_matmul.launches
        bad, ms = _read_all(url, [(f, expected[f]) for f in picks], BENCH_C)
        c.update(reads=len(picks), wrong=len(bad), ms_p50=_pct(ms, 50), ms_p99=_pct(ms, 99),
                 read_launches=gm.gf_matmul.launches - l0,
                 proxied=vs.turbo.counters()["proxied"] - p0)
        out["ec"] = c
        if bad or c["proxied"] < len(picks):
            raise SystemExit(f"phase 10: EC through the engine: {c}, wrong {bad[:5]}")
    finally:
        eng.stop(vs)
        master.stop()
        os.environ.pop("SWEED_TURBO", None)
    out.update(turbo=eng.totals(), launches=gm.gf_matmul.launches - state["l_phase"],
               nvidia_smi=state["smi"])
    emit(out)
    idle = [name for name in ("encode_launches", "read_launches") if not out["ec"][name]]
    if idle:
        raise SystemExit(f"phase 10: no kernel launch in {idle}")


# -- phase 11: the master's autopilot ------------------------------------------
# each volume's .dat (the reference's volumes grow to 30 GiB: a cut, PERF.md 4)
AUTO_BYTES = {"garbage": 256 * MiB, "cool": 256 * MiB, "cold": 128 * MiB}
AUTO_DELETE = 0.4  # the share of garbage's needles deleted
# the masters' knobs (cluster/lifecycle.py, cluster/volume_layout.py): a cycle
# a second, two cool observations before a move, one cycle of cooldown, and
# heat bands for counters that halve each second: warm from 5, cold below
# 0.3, nothing hot (an EC volume's reads must not un-EC it within the phase)
AUTO_MASTER_ENV = {
    "SWEED_LIFECYCLE": "1", "SWEED_LIFECYCLE_INTERVAL": "1",
    "SWEED_LIFECYCLE_COLD_STREAK": "2", "SWEED_LIFECYCLE_COOLDOWN": "1",
    "SWEED_HEAT_FLOOR": "5", "SWEED_TIER_FLOOR": "0.3", "SWEED_HEAT_CEILING": "1000000",
}
# the phase's volumes' heat half-life, set on their counters: the volume
# servers share this process, which read SWEED_HEAT_HALFLIFE at import. The
# cold volume's is shorter while it cools, so it crosses the cool band
# within one heartbeat and tiers instead of taking the EC on the way down.
AUTO_HALFLIFE, AUTO_COLD_HALFLIFE = 1.0, 0.1
TIER_READS = 64  # needles of the tiered volume read through the tier


class _Journals:
    """Polls the masters' plan journals (``lifecycle_{port}.json``) every
    50 ms: for each action of each master's cycles, the master's clock at
    the plan (the journal's ``started``) and when each state was first seen
    on disk."""

    def __init__(self, paths: dict):
        self.paths = paths  # master url -> journal path
        self.actions: dict = {}  # (url, cycle, id) -> record
        self.lock = threading.Lock()
        self.halt = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        while not self.halt.wait(0.05):
            for url, path in self.paths.items():
                try:
                    with open(path) as f:
                        doc = json.load(f)
                except (OSError, ValueError):
                    continue
                now = time.time()
                with self.lock:
                    for a in doc.get("actions", []):
                        rec = self.actions.setdefault((url, doc["cycle"], a["id"]), {
                            "master": url, "kind": a["kind"], "vid": a["vid"],
                            "planned_at": doc.get("started", now), "seen": {}})
                        rec["seen"].setdefault(a["state"], now)
                        rec["error"] = a.get("error", "")

    def find(self, kind: str, vid: int, state: str = "done") -> list:
        with self.lock:
            return [dict(r, seen=dict(r["seen"])) for r in self.actions.values()
                    if r["kind"] == kind and r["vid"] == vid and state in r["seen"]]

    def stop(self) -> None:
        self.halt.set()
        self.thread.join()


def _leader_among(urls: list) -> str:
    """The leader every one of ``urls`` names, if it is among them and says
    so itself; else ''."""
    sts = {}
    for u in urls:
        try:
            status, data, _ = _call(u, "GET", "/cluster/status")
        except OSError:
            return ""
        if status != 200:
            return ""
        sts[u] = json.loads(data)
    leads = {st["leader"] for st in sts.values()}
    lead = leads.pop() if len(leads) == 1 else ""
    return lead if lead in sts and sts[lead]["is_leader"] else ""


def phase11(state) -> None:
    """The master's autopilot, with no operator command after setup: three
    port masters (``master -peers A,B,C -mdir D``, subprocesses, the
    lifecycle on at a cycle a second, the tier at the in-repo fake S3), four
    port volume servers in this process (CUDA backend, the scrub on) and
    three volumes of their own collections filled with phase 8's needles,
    every fid from ``/dir/assign`` through the leader. ``garbage`` (256 MiB,
    40 % deleted) is vacuumed. ``cool`` (256 MiB, one read a second) is
    fleet-EC'd: the first leader, armed with
    ``lifecycle.journal.running=crash`` past its first action, dies as the
    EC starts; a follower is elected and runs it, once. A byte flipped in a
    shard of ``cool`` reaches the leader through the scrub, and its
    ``repair_shard`` rebuilds the shard on the card. ``cold`` (128 MiB,
    never read) moves to the tier; 64 reads through the tier warm it and
    the autopilot brings it back. The dead master restarts from its
    ``-mdir``, the leader stops, and the restarted master, elected, replays
    its journal: the EC it died in is done already, and runs no more. A
    seeded 1 024 live needles read back through the masters."""
    n_servers, threads = 4, 8
    out: dict = {"phase": 11, "servers": n_servers, "masters": 3,
                 "sizes_MiB": {k: v / MiB for k, v in AUTO_BYTES.items()},
                 "master_env": AUTO_MASTER_ENV, "halflife_s": AUTO_HALFLIFE}
    names = {k: f"auto11{k}" for k in AUTO_BYTES}  # collection of each volume
    murls = [f"127.0.0.1:{p}" for p in sorted(_free_port() for _ in range(3))]
    A, B, C = murls  # the lowest url campaigns first: A leads at start
    mdirs = {u: os.path.join(WORK, f"11master{i}") for i, u in enumerate(murls)}
    s3 = FakeS3Server(os.path.join(WORK, "11s3")).start()
    menv = dict(os.environ, PYTHONPATH=HERE, SWEED_TIER_ENDPOINT=s3.endpoint, **AUTO_MASTER_ENV)
    menv.pop("SWEED_FAULTPOINTS", None)
    procs: dict = {}
    logs = {u: os.path.join(WORK, f"11master{i}.log") for i, u in enumerate(murls)}

    def start_master(url: str, fault: str = "") -> None:
        env = dict(menv, SWEED_FAULTPOINTS=fault) if fault else menv
        deadline = time.monotonic() + 30
        while True:  # a restart retries its bind while the old socket clears
            with open(logs[url], "ab") as log:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "seaweedfs_tpu_torch", "master", "-ip", "127.0.0.1",
                     "-port", url.rsplit(":", 1)[1], "-peers", ",".join(murls),
                     "-mdir", mdirs[url]], cwd=HERE, env=env, stdout=log,
                    stderr=subprocess.STDOUT)
            while proc.poll() is None and time.monotonic() < deadline:
                try:
                    if _call(url, "GET", "/cluster/ping")[0] == 200:
                        procs[url] = proc
                        return
                except OSError:
                    time.sleep(0.05)
            if time.monotonic() >= deadline:
                proc.kill()
                raise SystemExit(f"phase 11: master {url} never answered")

    def stop_master(url: str) -> None:
        proc = procs.pop(url, None)
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()

    saved_env = {k: os.environ.get(k) for k in ("SWEED_SCRUB", "SWEED_SCRUB_RATE", "SWEED_TURBO")}
    # the native engine serves needles without marking heat (as in the JAX
    # package), and the autopilot steers by heat: the Python data plane
    os.environ.update(SWEED_SCRUB="1", SWEED_SCRUB_RATE=str(SCRUB_RATE), SWEED_TURBO="0")
    lock = threading.Lock()
    generates: collections.Counter = collections.Counter()
    moves: list = []  # (direction, vid, bytes, seconds) of each tier move
    patched = {"gen": VolumeServer._h_ec_generate, "up": Volume.tier_upload,
               "down": Volume.tier_download}

    def counted_generate(vs, h, path, q, body):  # one count a generate served
        with lock:
            generates[int(q.get("volume", 0))] += 1
        return patched["gen"](vs, h, path, q, body)

    def timed(direction: str, fn):
        def run(v, *args, **kwargs):
            size, t0 = v.size(), time.perf_counter()
            res = fn(v, *args, **kwargs)
            with lock:
                moves.append((direction, v.id, max(size, v.size()), time.perf_counter() - t0))
            return res
        return run

    VolumeServer._h_ec_generate = counted_generate
    Volume.tier_upload = timed("upload", patched["up"])
    Volume.tier_download = timed("download", patched["down"])
    servers, dirs = [], {}
    for i in range(n_servers):
        d = os.path.join(WORK, f"11srv{i}")
        vs = VolumeServer([d], host="127.0.0.1", port=_free_port(), master_url=",".join(murls),
                          pulse_seconds=0.5, ec_backend=EC_BACKEND)
        servers.append(vs)
        dirs[f"127.0.0.1:{vs.port}"] = d
    journals = _Journals({u: os.path.join(mdirs[u], f"lifecycle_{u.rsplit(':', 1)[1]}.json")
                          for u in murls})
    halt = threading.Event()
    readers: list = []
    t_start = time.perf_counter()
    ok = False

    def wait(cond, what: str, timeout: float = 120.0) -> float:
        t0 = time.perf_counter()
        if not _until(cond, timeout=timeout):
            raise SystemExit(f"phase 11: {what}")
        return time.perf_counter() - t0

    def done(kind: str, vid: int) -> list:
        return journals.find(kind, vid, "done")

    def volume(col: str):
        """(holder url, Volume) of the collection's one plain volume."""
        for vs in servers:
            for v in list(vs.store.locations[0].volumes.values()):
                if v.collection == col:
                    return f"127.0.0.1:{vs.port}", v
        raise SystemExit(f"phase 11: no volume of {col}")

    def grow(leader: str, key: str, halflife: float):
        _admin(leader, f"/vol/grow?collection={names[key]}&count=1&replication=000")
        url, v = volume(names[key])
        v.read_heat.halflife = v.write_heat.halflife = halflife
        return url, v

    def fill(leader: str, key: str, seed: int) -> tuple:
        blobs = _needle_blobs(seed, AUTO_BYTES[key])
        fids, _, _, write_s, errors = _upload_via_master(leader, names[key], blobs, threads)
        if errors:
            raise SystemExit(f"phase 11: uploads to {key} failed: {errors[:5]}")
        out.setdefault("upload", {})[key] = {
            "needles": len(blobs), "payload_MB": sum(map(len, blobs)) / 1e6, "s": write_s,
            "MBps": sum(map(len, blobs)) / write_s / 1e6}
        return dict(zip(fids, blobs))

    def reader(url: str, fids: list, period: float) -> threading.Event:
        """GET a needle of ``fids`` from the volume's holder every
        ``period`` seconds (its heat must not wait on a master) until the
        phase ends or the returned event is set."""
        done_reading = threading.Event()

        def run() -> None:
            rng = np.random.default_rng(len(readers))
            while not (halt.wait(period) or done_reading.is_set()):
                try:
                    _call(url, "GET", "/" + fids[int(rng.integers(len(fids)))])
                except OSError:
                    pass
        t = threading.Thread(target=run, daemon=True)
        t.start()
        readers.append(t)
        return done_reading

    def action_s(recs: list) -> list:
        return [{"master": murls.index(r["master"]), "plan_to_done_s":
                 r["seen"]["done"] - r["planned_at"]} for r in recs]

    try:
        for vs in servers:
            vs.start()
        start_master(A, fault="lifecycle.journal.running=crash::1")  # the vacuum's passes
        start_master(B)
        start_master(C)
        out["election_s"] = wait(lambda: _leader_among(murls) == A, "A never led", 60)
        wait(lambda: len(CommandEnv(A).data_nodes()) == n_servers,
             "the volume servers never registered", 30)

        # 1. garbage: fill, delete 40 %, keep it warm; the autopilot vacuums it
        gurl, gv = grow(A, "garbage", AUTO_HALFLIFE)
        live = fill(A, "garbage", 111)
        rng = np.random.default_rng(112)
        gone = list(rng.choice(sorted(live), int(len(live) * AUTO_DELETE), replace=False))
        failed: list = []

        def delete(fid: str) -> None:
            if _call(gurl, "DELETE", "/" + fid)[0] != 202:
                failed.append(fid)

        _parallel(delete, gone, threads)
        if failed:
            raise SystemExit(f"phase 11: deletes failed: {failed[:5]}")
        for fid in gone:
            live.pop(fid)
        reader(gurl, sorted(live), 0.2)  # five reads a second: warm
        dat_before = gv.size()
        wait(lambda: done("vacuum", gv.id), "the autopilot never vacuumed garbage", 60)
        out["vacuum"] = {"dat_bytes_before": dat_before, "dat_bytes_after": gv.size(),
                         "actions": action_s(done("vacuum", gv.id))}
        if gv.size() >= dat_before:
            raise SystemExit(f"phase 11: the vacuum left {gv.size()} bytes of {dat_before}")

        # 2. cool: one read a second keeps it cool; the autopilot fleet-ECs it,
        # and A dies as the EC starts (running is journaled, nothing executed)
        curl, cv = grow(A, "cool", AUTO_HALFLIFE)
        cool = fill(A, "cool", 113)
        live.update(cool)
        cool_reading = reader(curl, sorted(cool), 1.0)
        cool_vid = cv.id
        wait(lambda: procs[A].poll() is not None, "A never died in the EC", 120)
        t_crash = time.perf_counter()
        if procs[A].returncode != 113:
            raise SystemExit(f"phase 11: A exited {procs[A].returncode}, not by its fault")
        procs.pop(A)
        time.sleep(0.2)  # the journal poller reads what A left
        died_in = [(r["kind"], r["vid"]) for r in journals.find("ec", cool_vid, "running")
                   if r["master"] == A and "done" not in r["seen"]]
        if died_in != [("ec", cool_vid)]:
            raise SystemExit(f"phase 11: A did not die in cool's EC: {journals.actions}")
        t_lead = wait(lambda: _leader_among([B, C]) in (B, C), "no new leader", 60)
        leader = _leader_among([B, C])
        out["failover"] = {"crash_to_leader_s": t_lead, "leader": murls.index(leader)}
        wait(lambda: done("ec", cool_vid), "the new leader never EC'd cool", 120)
        ec_recs = done("ec", cool_vid)
        first_plan = min(r["planned_at"] for r in journals.find("ec", cool_vid, "running"))
        out["ec"] = {"actions": action_s(ec_recs), "from_first_plan_s":
                     ec_recs[0]["seen"]["done"] - first_plan, "generates": generates[cool_vid]}
        if [r["master"] for r in ec_recs] != [leader] or generates[cool_vid] != 1:
            raise SystemExit(f"phase 11: cool's EC ran {generates[cool_vid]} times: {ec_recs}")
        cool_reading.set()  # sealed: an EC volume takes no further move by its heat
        env = CommandEnv(leader)
        wait(lambda: len(env.ec_shard_locations(cool_vid)) == 14, "cool's 14 shards", 60)

        # 3. a byte of a cool shard decays on a server that holds the .vif,
        # and cold is filled, never read
        flipped = None
        for url, d in sorted(dirs.items()):
            cbase = volume_file_name(d, names["cool"], cool_vid)
            sids = [sid for sid in range(14) if os.path.exists(cbase + shard_ext(sid))]
            if sids and os.path.exists(cbase + ".vif"):
                with open(cbase + ".vif") as f:
                    want_sum = json.load(f)["shard_sums"][sids[0]]
                _flip(cbase + shard_ext(sids[0]), 4321)
                flipped = (url, sids[0])
                break
        if flipped is None:
            raise SystemExit("phase 11: no server holds a cool shard and the .vif")
        l_repair = gm.gf_matmul.launches
        t_flip = time.perf_counter()
        kurl, kv = grow(leader, "cold", AUTO_COLD_HALFLIFE)
        cold = fill(leader, "cold", 114)
        live.update(cold)
        wait(lambda: done("repair_shard", cool_vid), "the autopilot never repaired cool", 120)
        repair_s = time.perf_counter() - t_flip
        rebuilt = [volume_file_name(d, names["cool"], cool_vid) + shard_ext(flipped[1])
                   for d in dirs.values()]
        rebuilt = [p for p in rebuilt if os.path.exists(p)]
        sums_equal = [_sha256(p) == want_sum for p in rebuilt]
        out["repair"] = {"server": flipped[0], "shard": flipped[1], "flip_to_done_s": repair_s,
                         "actions": action_s(done("repair_shard", cool_vid)),
                         "launches": gm.gf_matmul.launches - l_repair, "sum_equal": sums_equal}
        if not sums_equal or not all(sums_equal):
            raise SystemExit(f"phase 11: the repaired shard differs: {out['repair']}")

        # 4. cold on the tier; 64 reads through it warm it, and it comes back
        wait(lambda: done("tier_up", kv.id), "the autopilot never tiered cold", 120)
        if not kv.is_tiered() or os.path.exists(kv.file_name() + ".dat"):
            raise SystemExit("phase 11: cold's .dat is still local")
        kv.read_heat.halflife = kv.write_heat.halflife = AUTO_HALFLIFE
        get_ms, wrong, gets0 = [], [], len(s3.ranged_gets)

        def tier_get(fid: str) -> None:
            status, data, sec = _call(kurl, "GET", "/" + fid)
            get_ms.append(sec * 1e3)
            if (status, data) != (200, cold[fid]):
                wrong.append((fid, status))

        # a burst from 8 clients: done before a beat and a cycle can start
        # the download, which would hold the volume's lock
        _parallel(tier_get, sorted(cold)[:TIER_READS], threads)
        if wrong:
            raise SystemExit(f"phase 11: reads through the tier went wrong: {wrong[:5]}")
        s3_ms = [t * 1e3 for t, n in s3.ranged_gets[gets0:] if n <= MiB + 4096]
        wait(lambda: done("tier_down", kv.id), "the autopilot never brought cold back", 60)
        reader(kurl, sorted(cold), 0.2)  # warm: no second trip to the tier
        ups = [m for m in moves if m[0] == "upload" and m[1] == kv.id]
        downs = [m for m in moves if m[0] == "download" and m[1] == kv.id]
        out["tier"] = {
            "tier_up": action_s(done("tier_up", kv.id)),
            "tier_down": action_s(done("tier_down", kv.id)),
            "upload_MBps": ups[0][2] / ups[0][3] / 1e6, "download_MBps":
            downs[0][2] / downs[0][3] / 1e6, "bytes": ups[0][2],
            "get_p50_ms": _pct(get_ms, 50), "get_p99_ms": _pct(get_ms, 99),
            "s3_ranged_gets": len(s3_ms), "s3_get_p50_ms": _pct(s3_ms, 50),
            "s3_get_p99_ms": _pct(s3_ms, 99)}
        if len(s3_ms) < len(get_ms):
            raise SystemExit(f"phase 11: {len(s3_ms)} ranged GETs reached the tier for "
                             f"{len(get_ms)} reads")

        # 5. A restarts from its -mdir, the leader stops, A leads and replays
        # its journal: the EC it died in is done, and runs no more
        start_master(A)
        wait(lambda: _leader_among(murls) == leader, "the restarted A never followed", 60)
        t0 = time.perf_counter()
        stop_master(leader)
        rest = [u for u in murls if u != leader]
        wait(lambda: _leader_among(rest) == A, "A never led again", 60)
        t_led = time.perf_counter() - t0

        def recovered() -> dict:
            st = json.loads(_call(A, "GET", "/lifecycle/status")[1])
            return st if st["recovery"] else {}

        wait(recovered, "A never replayed its journal", 30)
        lstatus = recovered()
        out["replay"] = {"stop_to_leader_s": t_led, "recovery": lstatus["recovery"],
                         "resumed": lstatus["counters"]["resumed"],
                         "abandoned": lstatus["counters"]["abandoned"]}
        time.sleep(2.5)  # two cycles: the resumed EC is re-validated
        out["replay"]["generates"] = generates[cool_vid]
        if lstatus["counters"]["resumed"] != 1 or generates[cool_vid] != 1:
            raise SystemExit(f"phase 11: the replay ran the EC again: {out['replay']}")

        # 6. a seeded sample of the live needles back through the masters
        # (every one before PR 16's cut)
        bad: list = []

        def back(item) -> None:
            fid, want = item
            status, data, _, _ = _client_get(A, fid)
            if (status, data) != (200, want):
                bad.append((fid, status))

        back_items = _sample(list(live.items()), READ_BACK_SAMPLE, 1111)
        out["read_back"] = {"needles": len(live), "sampled": len(back_items),
                            "s": _parallel(back, back_items, threads)}
        if bad:
            raise SystemExit(f"phase 11: {len(bad)} needles read back wrong: {bad[:5]}")
        out["actions_done"] = sorted({(r["kind"], r["vid"]) for r in journals.actions.values()
                                      if "done" in r["seen"]})
        ok = True
    finally:
        halt.set()
        for t in readers:
            t.join()
        journals.stop()
        for vs in servers:
            vs.stop()
        for u in list(procs):
            stop_master(u)
        s3.stop()
        VolumeServer._h_ec_generate = patched["gen"]
        Volume.tier_upload, Volume.tier_download = patched["up"], patched["down"]
        for k, val in saved_env.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
        if not ok:
            for rec in sorted(journals.actions.values(), key=lambda r: r["planned_at"]):
                print(f"phase 11: journal {rec}", file=sys.stderr)
            for u, path in logs.items():
                with open(path, "rb") as f:
                    tail = f.read()[-3000:].decode("utf-8", "replace")
                print(f"phase 11: master {murls.index(u)} log tail:\n{tail}", file=sys.stderr)
    out.update(wall_s=time.perf_counter() - t_start, generates=dict(generates),
               launches=gm.gf_matmul.launches - state["l_phase"], nvidia_smi=state["smi"])
    emit(out)


# -- phase 12: the filer path ------------------------------------------------
FILER_COL = "filer12"  # the filer's own collection
FILER_CHUNK = 32 * MiB  # weed filer -chunkSizeMB 32
FILER_SMALL = 1024  # files of 1 KiB-1 MiB, log-uniform (phase 6's mix)
FILER_DIRS = 16
# streaming PUTs and a ?cipher=true object, two chunks each (160, 160 and
# 96 MiB before a cut: PERF.md section 4)
FILER_LARGE = (64 * MiB, 64 * MiB)
FILER_CIPHER = 64 * MiB
# the CSVs: single-chunk size and count (4 before a cut), the 3-chunk one;
# the gzip'd one is the last single-chunk CSV compressed
FILER_CSV = (32 * MiB, 3, 96 * MiB)
FILER_RANGED = 32  # ranged GETs on the large objects (256 before a cut: PERF.md section 4)
FILER_SEALED_READS = 256  # small files read back after the seal (a seeded sample; a cut)
FILER_PAGE = 50  # listing page size (limit, lastFileName)
FILER_THREADS = 8
FILER_QUERY_BACKEND = None  # the filer's default: $SWEED_QUERY_BACKEND, else cuda
FILER_PROBE_SQL = "SELECT * FROM s3object WHERE region = 'east' AND score > 995"


def _filer_call(url: str, method: str, path: str, body=None,
                headers=None) -> tuple[int, bytes, float]:
    """One request on a fresh connection, the body streamed from a file-like
    in 1 MiB pieces when it is one: (status, body, seconds)."""
    conn = http.client.HTTPConnection(url, timeout=600, blocksize=MiB)
    try:
        t0 = time.perf_counter()
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, data, time.perf_counter() - t0
    finally:
        conn.close()


def _select_xml(sql: str, compression: str) -> bytes:
    """A SelectObjectContent request: CSV in (header row), JSON out."""
    sql = sql.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
    return ("<SelectObjectContentRequest>"
            f"<Expression>{sql}</Expression><ExpressionType>SQL</ExpressionType>"
            f"<InputSerialization><CompressionType>{compression}</CompressionType>"
            "<CSV><FileHeaderInfo>USE</FileHeaderInfo></CSV></InputSerialization>"
            "<OutputSerialization><JSON/></OutputSerialization>"
            "</SelectObjectContentRequest>").encode()


def phase12(state) -> None:
    """The filer path: the port's master, four port volume servers (CUDA
    backend, ``weed volume`` defaults, the engine on) and one port filer
    (``weed filer`` defaults: 32 MiB chunks, a sqlite ``filer.db`` on disk,
    replication 000, four uploads and four chunk fetches in flight), in one
    process, with its own collection grown on four volumes. From 8 client
    threads: 1 024 small files (1 KiB-1 MiB) under 16 directories; two 64
    MiB streaming PUTs and one 64 MiB ``?cipher=true`` object; CSV objects
    of phase 7's schema: three of 32 MiB (one chunk), one of 96 MiB (three),
    and one of the 32 MiB ones again gzip'd. Phase 7 ran the same six
    queries in this process first, so none is a first use on the card. Every directory listed page by page, every file
    read back, 32 ranged GETs; a directory renamed and another deleted
    recursively, its chunks purged. Phase 7's six queries through the
    filer's ``/_query`` to each single-chunk CSV (pushed down to the volume
    server holding it) and to the 3-chunk one (scanned on the filer's
    card), and the probe as ``/_select`` on the 3-chunk and gzip'd objects;
    every reply equal to the cpu backend's. Then the shell's ``ec.encode``
    seals every volume of the collection (4/4/3/3), the server with shards
    1, 5, 9, 13 of the first stops, a seeded 256 of the small files and the
    cipher'd object read back through the filer and the probe runs again on
    a sealed single-chunk CSV and the 3-chunk one, through gf_matmul."""
    t_start = time.perf_counter()
    n_servers, threads = 4, FILER_THREADS
    out: dict = {"phase": 12, "servers": n_servers, "collection": FILER_COL,
                 "chunk_MiB": FILER_CHUNK / MiB, "client_threads": threads}
    steps: dict = {}
    master = MasterServer(host="127.0.0.1", port=_free_port(), node_timeout=3.0).start()
    servers, stopped = [], set()
    for i in range(n_servers):
        servers.append(VolumeServer([os.path.join(WORK, f"12srv{i}")], host="127.0.0.1",
                                    port=_free_port(), master_url=master.url,
                                    pulse_seconds=0.5, ec_backend=EC_BACKEND))
    by_url = {f"127.0.0.1:{vs.port}": vs for vs in servers}
    eng = _Engines(12, servers)
    filer_dir = os.path.join(WORK, "12filer")
    os.makedirs(filer_dir)
    filer = None
    env = CommandEnv(master.url)
    cnt = QUERY_COUNTERS

    def step(name: str, fn):
        l0, t0 = gm.gf_matmul.launches, time.perf_counter()
        res = fn()
        steps[name] = {"s": time.perf_counter() - t0, "launches": gm.gf_matmul.launches - l0}
        return res

    def served() -> int:  # /_query scans the volume servers ran themselves
        return sum(vs.queries_served for vs in servers)

    def deleted() -> int:  # needles deleted from the collection's volumes
        return sum(v.deleted_count() for vs in servers for loc in vs.store.locations
                   for v in list(loc.volumes.values()) if v.collection == FILER_COL)

    try:
        for vs in servers:
            vs.start()
        eng.check()
        if not _until(lambda: len(master.master.topo.data_nodes()) == n_servers):
            raise SystemExit("phase 12: the volume servers did not register")
        grown = _admin(master.url, f"/vol/grow?collection={FILER_COL}&count=4&replication=000")
        if grown != {"count": 4}:
            raise SystemExit(f"phase 12: /vol/grow answered {grown}")
        filer = FilerServer(host="127.0.0.1", port=_free_port(), master_url=master.url,
                            chunk_size=FILER_CHUNK, db_path=os.path.join(filer_dir, "filer.db"),
                            collection=FILER_COL, replication="000", read_window=4,
                            write_window=4, query_backend=FILER_QUERY_BACKEND).start()
        furl = filer.url

        # the data, from the seed
        t0 = time.perf_counter()
        rng = np.random.default_rng(12)
        small = {}
        for i in range(FILER_SMALL):
            size = int(np.exp(rng.uniform(np.log(1024), np.log(MiB))))
            small[f"/small/d{i % FILER_DIRS:02d}/f{i:04d}.bin"] = rng.bytes(size)
        large = {f"/large/obj{i}.bin": rng.bytes(n) for i, n in enumerate(FILER_LARGE)}
        cipher = {"/large/secret.bin": rng.bytes(FILER_CIPHER)}
        one_size, n_one, multi_size = FILER_CSV
        csvs = {f"/csv/one{i}.csv": query_csv(120 + i, one_size) for i in range(n_one)}
        gz_plain = csvs[f"/csv/one{n_one - 1}.csv"]
        csvs["/csv/three.csv"] = query_csv(124, multi_size)
        gz = {"/csv/gz.csv.gz": gzip.compress(gz_plain, compresslevel=1)}
        out["data_gen_s"] = time.perf_counter() - t0
        files = {**small, **large, **cipher, **csvs, **gz}

        # 1. small files, POST from 8 threads
        post_ms, errors = [], []

        def post(path: str) -> None:
            status, body, sec = _filer_call(furl, "POST", path, small[path])
            post_ms.append(sec * 1e3)
            if status != 201:
                errors.append((path, status, body[:200]))

        sec = _parallel(post, list(small), threads)
        nbytes = sum(map(len, small.values()))
        out["small_write"] = {"files": len(small), "bytes": nbytes, "s": sec,
                              "MBps": nbytes / sec / 1e6, "post_ms_p50": _pct(post_ms, 50),
                              "post_ms_p99": _pct(post_ms, 99)}
        if errors:
            raise SystemExit(f"phase 12: small-file POSTs failed: {errors[:5]}")

        # 2. large objects by streaming PUT; 3. the CSVs
        put = {}
        for path, data in (*large.items(), *cipher.items(), *csvs.items(), *gz.items()):
            q = "?cipher=true" if path in cipher else ""
            status, body, sec = _filer_call(
                furl, "PUT", path + q, io.BytesIO(data), {"Content-Length": str(len(data))})
            if status != 201:
                raise SystemExit(f"phase 12: PUT {path} answered {status}: {body[:200]!r}")
            put[path] = {"MiB": len(data) / MiB, "s": sec, "MBps": len(data) / sec / 1e6,
                         "chunks": json.loads(body)["chunks"]}
        want_chunks = {**{p: -(-len(large[p]) // FILER_CHUNK) for p in large},
                       "/large/secret.bin": -(-FILER_CIPHER // FILER_CHUNK),
                       **{p: 1 for p in csvs}, "/csv/three.csv": 3, "/csv/gz.csv.gz": 1}
        bad = {p: put[p]["chunks"] for p in want_chunks if put[p]["chunks"] != want_chunks[p]}
        if bad:
            raise SystemExit(f"phase 12: chunk counts {bad}, want {want_chunks}")
        big = [*large, *cipher]
        out["large_put"] = {p: put[p] for p in big}
        out["large_put_MBps"] = sum(len(files[p]) for p in big) / sum(
            put[p]["s"] for p in big) / 1e6
        out["csv_put"] = {p: put[p] for p in (*csvs, *gz)}

        # 4. listing, read-back, ranged GETs
        list_ms, listed = [], 0
        for d in sorted({p.rsplit("/", 1)[0] for p in files}):
            last, names = "", []
            while True:
                status, body, sec = _filer_call(
                    furl, "GET", f"{d}/?limit={FILER_PAGE}&lastFileName={last}")
                list_ms.append(sec * 1e3)
                page = json.loads(body)["entries"]
                names += [e["name"] for e in page]
                if len(page) < FILER_PAGE:
                    break
                last = page[-1]["name"]
            want = sorted(p.rsplit("/", 1)[1] for p in files if p.rsplit("/", 1)[0] == d)
            if names != want:
                raise SystemExit(f"phase 12: {d} lists {len(names)} names, want {len(want)}")
            listed += len(names)
        out["listing"] = {"entries": listed, "pages": len(list_ms),
                          "ms_p50": _pct(list_ms, 50), "ms_p99": _pct(list_ms, 99)}

        def read_all(paths: list, what: str) -> dict:
            ms, bad = {}, []

            def get(path: str) -> None:
                status, data, sec = _filer_call(furl, "GET", path)
                ms[path] = sec
                if status != 200 or data != files[path]:
                    bad.append((path, status, len(data)))

            sec = _parallel(get, paths, threads)
            if bad:
                raise SystemExit(f"phase 12: {len(bad)} {what} reads wrong: {bad[:5]}")
            sm = [ms[p] * 1e3 for p in paths if p in small]
            lg = [p for p in paths if p not in small]
            return {"files": len(paths), "s": sec, "small_ms_p50": _pct(sm, 50),
                    "small_ms_p99": _pct(sm, 99),
                    "large_MBps": sum(len(files[p]) for p in lg) / sum(ms[p] for p in lg) / 1e6}

        out["read_back"] = step("read_back", lambda: read_all(list(files), "read-back"))
        rr = np.random.default_rng(1212)
        rng_ms, bad = [], []
        for _ in range(FILER_RANGED):
            path = big[int(rr.integers(len(big)))]
            n = int(rr.integers(1, MiB))
            lo = int(rr.integers(0, len(files[path]) - n))
            status, data, sec = _filer_call(furl, "GET", path,
                                            headers={"Range": f"bytes={lo}-{lo + n - 1}"})
            rng_ms.append(sec * 1e3)
            if status != 206 or data != files[path][lo:lo + n]:
                bad.append((path, lo, n, status))
        out["ranged_get"] = {"n": FILER_RANGED, "ms_p50": _pct(rng_ms, 50),
                             "ms_p99": _pct(rng_ms, 99), "bad": len(bad)}
        if bad:
            raise SystemExit(f"phase 12: ranged GETs wrong: {bad[:5]}")

        # rename one directory, delete another recursively: its chunks purged
        status, body, _ = _filer_call(furl, "POST", "/small/d00?mv.to=/small/renamed00")
        if status != 200:
            raise SystemExit(f"phase 12: rename answered {status}: {body[:200]!r}")
        for p in [p for p in small if p.startswith("/small/d00/")]:
            np_ = p.replace("/small/d00/", "/small/renamed00/")
            small[np_] = files[np_] = small.pop(p)
            files.pop(p)
        gone = [p for p in small if p.startswith("/small/d01/")]
        n_chunks = sum(len(filer.filer.find_entry(p).chunks) for p in gone)
        d0 = deleted()
        status, body, _ = _filer_call(furl, "DELETE", "/small/d01?recursive=true")
        if status != 200 or json.loads(body)["purged_chunks"] != n_chunks:
            raise SystemExit(f"phase 12: recursive delete answered {status}: {body[:200]!r}")
        t0 = time.perf_counter()
        if not _until(lambda: deleted() - d0 >= n_chunks, timeout=60):
            raise SystemExit(f"phase 12: {deleted() - d0} of {n_chunks} chunks purged")
        for p in gone:
            small.pop(p)
            files.pop(p)
        renamed = sorted(p for p in small if "/renamed00/" in p)
        checks = [_filer_call(furl, "GET", p) for p in renamed[:8]]
        if any(s != 200 or d != files[p] for (s, d, _), p in zip(checks, renamed)) or \
                _filer_call(furl, "GET", gone[0])[0] != 404:
            raise SystemExit("phase 12: the renamed or deleted directory reads wrong")
        out["rename_delete"] = {"renamed": len(renamed), "deleted_files": len(gone),
                                "purged_chunks": n_chunks, "purge_s": time.perf_counter() - t0,
                                "volume_deletes": deleted() - d0}

        # 5. queries: pushdown (single chunk) and filer-side (three chunks)
        def ask(path: str, req: dict) -> tuple[dict, float]:
            status, body, sec = _filer_call(furl, "POST", "/_query",
                                            json.dumps(dict(req, path=path, input="csv")).encode())
            if status != 200:
                raise SystemExit(f"phase 12: /_query {path} answered {status}: {body[:300]!r}")
            return json.loads(body), sec

        singles = [p for p in csvs if p != "/csv/three.csv"]
        # the cpu backend's replies, made on three threads while the filer
        # answers on the card
        pool = concurrent.futures.ThreadPoolExecutor(3)
        wants = {(name, path): pool.submit(execute_request, csvs[path],
                                           dict(req, input="csv"), backend="cpu")
                 for name, req in QUERIES for path in (*singles, "/csv/three.csv")}
        pool.shutdown(wait=False)
        q0, r0, e0 = served(), filer.query_routes(), TorchKernels.evaluations["cuda"]
        s0 = cnt["scans"].value(backend="cuda")
        per_query, mismatches, probe_rows = {}, [], {}
        t0 = time.perf_counter()
        for name, req in QUERIES:
            lat = {"pushdown": [], "filer_side": []}
            for path in (*singles, "/csv/three.csv"):
                got, sec = ask(path, req)
                lat["pushdown" if path in singles else "filer_side"].append(sec * 1e3)
                want = wants.pop((name, path)).result()[1]
                if got != want:
                    mismatches.append((name, path))
                if name == "probe":
                    probe_rows[path] = got
            per_query[name] = {"pushdown_ms_p50": _pct(lat["pushdown"], 50),
                               "pushdown_ms_p99": _pct(lat["pushdown"], 99),
                               "filer_side_ms": lat["filer_side"][0]}
        routes = filer.query_routes()
        out["query"] = {
            "per_query": per_query, "s": time.perf_counter() - t0,
            "pushdown": routes["pushdown"] - r0["pushdown"],
            "filer_side": routes["filer_side"] - r0["filer_side"],
            "volume_server_scans": served() - q0,
            "evaluations_cuda": TorchKernels.evaluations["cuda"] - e0,
            "scans_cuda": cnt["scans"].value(backend="cuda") - s0,
            "mismatches_vs_cpu": mismatches}
        sent = len(singles) * len(QUERIES)
        if mismatches:
            raise SystemExit(f"phase 12: replies differ from the cpu backend's: {mismatches}")
        if out["query"]["pushdown"] != sent or out["query"]["volume_server_scans"] != sent \
                or out["query"]["filer_side"] != len(QUERIES):
            raise SystemExit(f"phase 12: the pushdown did not engage as sent: {out['query']}")
        piece = csvs["/csv/one0.csv"][:ORACLE_BYTES]
        piece = piece[: piece.rfind(b"\n") + 1]
        bad_oracle = []
        for name, req in QUERIES:
            select, where, limit = _query_args(req)
            want = run_query(piece, "csv", select=select, where=where, limit=limit)
            if execute_request(piece, dict(req, input="csv"), backend="cuda")[1]["rows"] != want:
                bad_oracle.append(name)
        out["query"]["oracle_mismatches"] = bad_oracle
        if bad_oracle:
            raise SystemExit(f"phase 12: the scan differs from the engine on {bad_oracle}")

        # /_select: the probe, CSV in, JSON out, on the 3-chunk and gzip'd objects
        sel = {}
        for path, plain, comp in (("/csv/three.csv", csvs["/csv/three.csv"], "NONE"),
                                  ("/csv/gz.csv.gz", gz_plain, "GZIP")):
            status, body, sec = _filer_call(furl, "POST", f"/_select?path={path}",
                                            _select_xml(FILER_PROBE_SQL, comp))
            if status != 200:
                raise SystemExit(f"phase 12: /_select {path} answered {status}: {body[:300]!r}")
            events = list(s3select.iter_events(body))  # every prelude and message CRC
            kinds = [e["headers"][":event-type"] for e in events]
            rows = [json.loads(x) for e in events if e["headers"][":event-type"] == "Records"
                    for x in e["payload"].splitlines()]
            want = execute_request(plain, {"input": "csv", "sql": FILER_PROBE_SQL},
                                   backend="cpu")[1]["rows"]
            sel[path] = {"ms": sec * 1e3, "MBps": len(files[path]) / sec / 1e6,
                         "events": len(events), "rows": len(rows), "crc_ok": True}
            if rows != want or kinds[-2:] != ["Stats", "End"]:
                raise SystemExit(f"phase 12: /_select {path} rows differ ({len(rows)} vs "
                                 f"{len(want)}) or ends {kinds[-2:]}")
        out["select"] = sel

        # 6. seal every volume of the collection, lose a server, read back
        vids = sorted({FileId.parse(c.file_id).volume_id for p in files
                       for c in filer.filer.find_entry(p).chunks})
        encodes = {}
        with _ShellCalls() as sc:
            def seal():
                for vid in vids:
                    encodes[vid] = run_command(
                        env, f"ec.encode -volumeId={vid} -collection={FILER_COL}")["spread"]
            step("ec_encode", seal)
        shapes = {vid: sorted(len(s) for s in sp.values()) for vid, sp in encodes.items()}
        out["encode"] = {"volumes": vids, "spreads": encodes, "s": steps["ec_encode"]["s"],
                         "generate_s": sc.seconds["/admin/ec/generate"],
                         "copy_s": sc.seconds["/admin/ec/copy"]}
        if any(s != [3, 3, 4, 4] for s in shapes.values()):
            raise SystemExit(f"phase 12: the shards spread as {encodes}")
        if not _until(lambda: all(len(env.ec_shard_locations(v)) == 14
                                  and not master.master.topo.lookup(FILER_COL, v)
                                  for v in vids)):
            raise SystemExit("phase 12: the master never saw every volume's 14 shards")
        victim = next(t for t, sids in encodes[vids[0]].items() if sids == [1, 5, 9, 13])
        eng.stop(by_url[victim])
        stopped.add(victim)

        def dropped() -> bool:
            return not any(victim in urls for v in vids
                           for urls in master.master.lookup_ec_volume(v)[
                               "shard_id_locations"].values())
        t0 = time.perf_counter()
        if not _until(dropped, timeout=60):
            raise SystemExit(f"phase 12: the master still names {victim} as a shard holder")
        out["reaped_after_s"] = time.perf_counter() - t0
        out["victim_shards"] = {v: encodes[v].get(victim, []) for v in vids}
        # an empty chunk cache: every read below reaches the volume servers
        filer.chunk_cache = type(filer.chunk_cache)()
        # a seeded sample of the small files and the cipher'd object (every
        # small file before PR 16's cut, every file before PR 14's: PERF.md
        # section 4)
        sealed_small = sorted(np.random.default_rng(1212).choice(
            sorted(small), min(FILER_SEALED_READS, len(small)), replace=False))
        out["degraded_read"] = step("degraded_read", lambda: read_all(
            [*sealed_small, *cipher], "degraded"))
        q0, r0 = served(), filer.query_routes()
        ec_bad, ec_ms = [], []

        sealed = (singles[0], "/csv/three.csv")  # one of each (4 + 1 before a cut)

        def ec_queries():
            for path in sealed:
                got, sec = ask(path, QUERIES[0][1])
                ec_ms.append(sec * 1e3)
                if got != probe_rows[path]:
                    ec_bad.append(path)
        step("ec_query", ec_queries)
        routes = filer.query_routes()
        out["ec_query"] = {"ms": ec_ms, "pushdown": routes["pushdown"] - r0["pushdown"],
                           "filer_side": routes["filer_side"] - r0["filer_side"],
                           "volume_server_scans": served() - q0, "mismatches": ec_bad}
        if ec_bad or out["ec_query"]["pushdown"] != 1 \
                or out["ec_query"]["volume_server_scans"] != 1:
            raise SystemExit(f"phase 12: the sealed CSVs' queries failed: {out['ec_query']}")
        out["filer_status"] = {k: v for k, v in json.loads(
            _filer_call(furl, "GET", "/_status")[1]).items()
            if k in ("chunk_cache", "fid_leases", "hedge", "query_routes")}
    finally:
        if filer is not None:
            filer.stop()
        for url, vs in by_url.items():
            if url not in stopped:
                eng.stop(vs)
        master.stop()
    out.update(turbo=eng.totals(), steps=steps, wall_s=time.perf_counter() - t_start,
               launches=gm.gf_matmul.launches - state["l_phase"], nvidia_smi=state["smi"])
    emit(out)
    idle = [name for name in ("ec_encode", "degraded_read") if not steps[name]["launches"]]
    if idle:
        raise SystemExit(f"phase 12: no kernel launch in {idle}")


S3_BUCKET = "bucket13"  # the read-only identity may read and list this one only
S3_OBJECTS = 512  # objects of 1 KiB-1 MiB, log-uniform (phase 6's mix)
S3_PART = 8 * MiB  # the AWS CLI's multipart_chunksize and multipart_threshold
S3_MULTIPART = 64 * MiB  # eight parts, the last one an UploadPartCopy
S3_STREAM = 64 * MiB  # put_object_streaming (aws-chunked, signed chunks)
S3_STREAM_CHUNK = MiB  # the aws-chunked frame size
S3_CSV = (32 * MiB, 96 * MiB)  # phase 12's schema: one chunk and three
S3_PAGE = 100  # ListObjectsV2 max-keys
S3_RANGED = 32
S3_SEALED_READS = 64  # small objects read back after the seal (a seeded sample)
S3_THREADS = 8
S3_IDENTITIES = {"identities": [
    {"name": "admin", "credentials": [{"accessKey": "AKIA13ADMIN", "secretKey": "admin13secret"}],
     "actions": ["Admin"]},
    {"name": "reader", "credentials": [{"accessKey": "AKIA13READ", "secretKey": "read13secret"}],
     "actions": [f"Read:{S3_BUCKET}", f"List:{S3_BUCKET}"]},
]}


def _post_policy_form(bucket: str, key: str, data: bytes, access_key: str,
                      secret: str) -> tuple[bytes, str]:
    """A browser POST upload: a SigV4-signed POST policy and the
    multipart/form-data body that carries it."""
    import base64
    import hmac
    from datetime import datetime, timedelta, timezone

    from seaweedfs_tpu_torch.s3api.auth import IAM

    now = datetime.now(timezone.utc)
    policy = base64.b64encode(json.dumps({
        "expiration": (now + timedelta(minutes=10)).strftime("%Y-%m-%dT%H:%M:%S.000Z"),
        "conditions": [{"bucket": bucket}, ["starts-with", "$key", "forms/"],
                       ["content-length-range", 1, 1 << 20]],
    }).encode()).decode()
    date = now.strftime("%Y%m%d")
    sig = hmac.new(IAM.signing_key(secret, date, "us-east-1", "s3"), policy.encode(),
                   hashlib.sha256).hexdigest()
    fields = {"key": key, "policy": policy, "x-amz-algorithm": "AWS4-HMAC-SHA256",
              "x-amz-credential": f"{access_key}/{date}/us-east-1/s3/aws4_request",
              "x-amz-date": date + "T000000Z", "x-amz-signature": sig}
    boundary = "phase13boundary"
    body = b"".join(f"--{boundary}\r\nContent-Disposition: form-data; name=\"{k}\"\r\n\r\n"
                    f"{v}\r\n".encode() for k, v in fields.items())
    body += (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
             f"filename=\"f.bin\"\r\nContent-Type: application/octet-stream\r\n\r\n"
             ).encode() + data + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def phase13(state) -> None:
    """The S3 gateway: the port's master, four port volume servers (CUDA
    backend, ``weed volume`` defaults, the engine on), one port filer
    (``weed filer`` defaults: 32 MiB chunks, a sqlite ``filer.db``) and the
    port's S3 gateway on ``weed s3`` defaults, with an ``s3.json`` of two
    identities (full access; read and list of one bucket), in one process.
    Through the port's ``S3Client`` with SigV4, from 8 threads: a bucket,
    512 objects of 1 KiB-1 MiB; one 64 MiB multipart upload of 8 MiB parts,
    the last an UploadPartCopy; one 64 MiB ``put_object_streaming``; phase
    12's schema as CSVs of 32 MiB (one chunk) and 96 MiB (three). Then
    ListObjectsV2 by pages of 100, every object read back, 32 ranged GETs,
    a presigned GET and a POST-policy upload; the read-only identity's PUT
    is refused (403 AccessDenied) and so is a bad signature (403
    SignatureDoesNotMatch); SelectObjectContent with phase 7's probe on both
    CSVs, its rows equal to the cpu backend's. Then the shell's
    ``ec.encode`` seals the volumes, the server with shards 1, 5, 9, 13 of
    the first stops, and a seeded 64 of the small objects read back equal,
    and SelectObjectContent on the sealed 32 MiB CSV gives the same rows,
    both through gf_matmul; that Select's ``X-Sweed-Trace-Id`` leads,
    through the daemons' ``/debug/traces`` and ``/_debug/traces``, to one
    tree with the gateway's, the filer's and a volume server's spans."""
    from seaweedfs_tpu_torch.s3api import IAM, S3ApiServer
    from seaweedfs_tpu_torch.s3api.s3_client import S3Client
    from seaweedfs_tpu_torch.s3api.xml_util import find_text, findall, parse_xml
    from seaweedfs_tpu_torch.stats import trace as trace_mod

    t_start = time.perf_counter()
    n_servers, threads, bucket = 4, S3_THREADS, S3_BUCKET
    out: dict = {"phase": 13, "servers": n_servers, "chunk_MiB": FILER_CHUNK / MiB,
                 "client_threads": threads}
    steps: dict = {}
    master = MasterServer(host="127.0.0.1", port=_free_port(), node_timeout=3.0).start()
    servers, stopped = [], set()
    for i in range(n_servers):
        servers.append(VolumeServer([os.path.join(WORK, f"13srv{i}")], host="127.0.0.1",
                                    port=_free_port(), master_url=master.url,
                                    pulse_seconds=0.5, ec_backend=EC_BACKEND))
    by_url = {f"127.0.0.1:{vs.port}": vs for vs in servers}
    eng = _Engines(13, servers)
    s3_dir = os.path.join(WORK, "13s3")
    os.makedirs(s3_dir)
    filer = api = None
    env = CommandEnv(master.url)

    def step(name: str, fn):
        l0, t0 = gm.gf_matmul.launches, time.perf_counter()
        res = fn()
        steps[name] = {"s": time.perf_counter() - t0, "launches": gm.gf_matmul.launches - l0}
        return res

    try:
        for vs in servers:
            vs.start()
        eng.check()
        if not _until(lambda: len(master.master.topo.data_nodes()) == n_servers):
            raise SystemExit("phase 13: the volume servers did not register")
        grown = _admin(master.url, "/vol/grow?count=4&replication=000")
        if grown != {"count": 4}:
            raise SystemExit(f"phase 13: /vol/grow answered {grown}")
        filer = FilerServer(host="127.0.0.1", port=_free_port(), master_url=master.url,
                            chunk_size=FILER_CHUNK, db_path=os.path.join(s3_dir, "filer.db"),
                            query_backend=FILER_QUERY_BACKEND).start()
        conf = os.path.join(s3_dir, "s3.json")
        with open(conf, "w") as f:
            json.dump(S3_IDENTITIES, f)
        with open(conf) as f:  # as `s3 -config s3.json` loads it
            iam = IAM.from_config(json.load(f))
        api = S3ApiServer(host="127.0.0.1", port=_free_port(), filer_url=filer.url,
                          iam=iam).start()
        endpoint = f"http://{api.url}"
        admin = S3Client(endpoint, "AKIA13ADMIN", "admin13secret")
        reader = S3Client(endpoint, "AKIA13READ", "read13secret")

        # the data, from the seed
        t0 = time.perf_counter()
        rng = np.random.default_rng(13)
        small = {}
        for i in range(S3_OBJECTS):
            size = int(np.exp(rng.uniform(np.log(1024), np.log(MiB))))
            small[f"obj/{i % 16:02d}/o{i:04d}.bin"] = rng.bytes(size)
        streamed = rng.bytes(S3_STREAM)
        parts = [rng.bytes(S3_PART) for _ in range(S3_MULTIPART // S3_PART - 1)]
        csvs = {"csv/one.csv": query_csv(130, S3_CSV[0]),
                "csv/three.csv": query_csv(131, S3_CSV[1])}
        out["data_gen_s"] = time.perf_counter() - t0
        status, body, _ = admin.create_bucket(bucket)
        if status != 200:
            raise SystemExit(f"phase 13: CreateBucket answered {status}: {body[:200]!r}")

        # 1. PutObject from 8 threads
        put_ms, errors = [], []

        def put(key: str) -> None:
            t0 = time.perf_counter()
            status, body, _ = admin.put_object(bucket, key, small[key])
            put_ms.append((time.perf_counter() - t0) * 1e3)
            if status != 200:
                errors.append((key, status, body[:200]))

        sec = _parallel(put, list(small), threads)
        nbytes = sum(map(len, small.values()))
        out["put"] = {"objects": len(small), "bytes": nbytes, "s": sec,
                      "MBps": nbytes / sec / 1e6, "ms_p50": _pct(put_ms, 50),
                      "ms_p99": _pct(put_ms, 99)}
        if errors:
            raise SystemExit(f"phase 13: PUTs failed: {errors[:5]}")

        # 2. the streaming (aws-chunked) upload, then the multipart upload whose
        # last part is copied from it
        t0 = time.perf_counter()
        frames = [streamed[i:i + S3_STREAM_CHUNK] for i in range(0, S3_STREAM, S3_STREAM_CHUNK)]
        status, body, _ = admin.put_object_streaming(bucket, "large/streamed.bin", frames)
        if status != 200:
            raise SystemExit(f"phase 13: streaming PUT answered {status}: {body[:200]!r}")
        sec = time.perf_counter() - t0
        out["streaming_put"] = {"MiB": S3_STREAM / MiB, "frames": len(frames), "s": sec,
                                "MBps": S3_STREAM / sec / 1e6}
        t0 = time.perf_counter()
        uid = admin.initiate_multipart(bucket, "large/multi.bin")
        etags = [None] * (len(parts) + 1)

        def upload(i: int) -> None:
            etags[i] = (i + 1, admin.upload_part(bucket, "large/multi.bin", uid, i + 1, parts[i]))

        _parallel(upload, list(range(len(parts))), threads)
        lo = (S3_STREAM - S3_PART) // 2  # a part from the streamed object's middle
        copy_range = (lo, lo + S3_PART - 1)
        status, body, _ = admin.request(
            "PUT", f"/{bucket}/large/multi.bin",
            query={"partNumber": str(len(parts) + 1), "uploadId": uid},
            headers={"X-Amz-Copy-Source": f"/{bucket}/large/streamed.bin",
                     "X-Amz-Copy-Source-Range": "bytes=%d-%d" % copy_range})
        if status != 200:
            raise SystemExit(f"phase 13: UploadPartCopy answered {status}: {body[:200]!r}")
        etags[-1] = (len(parts) + 1, find_text(parse_xml(body), "ETag").strip('"'))
        status, body, _ = admin.complete_multipart(bucket, "large/multi.bin", uid, etags)
        if status != 200:
            raise SystemExit(f"phase 13: CompleteMultipartUpload answered {status}: "
                             f"{body[:200]!r}")
        sec = time.perf_counter() - t0
        multi = b"".join(parts) + streamed[copy_range[0]:copy_range[1] + 1]
        out["multipart"] = {"MiB": len(multi) / MiB, "parts": len(etags),
                            "part_MiB": S3_PART / MiB, "copied_parts": 1, "s": sec,
                            "MBps": len(multi) / sec / 1e6}

        # 3. the CSVs
        for key, data in csvs.items():
            status, body, _ = admin.put_object(bucket, key, data)
            if status != 200:
                raise SystemExit(f"phase 13: PUT {key} answered {status}: {body[:200]!r}")
        objects = {**small, "large/streamed.bin": streamed, "large/multi.bin": multi, **csvs}
        chunks = {k: len(filer.filer.find_entry(f"/buckets/{bucket}/{k}").chunks)
                  for k in csvs}
        if chunks != {"csv/one.csv": 1, "csv/three.csv": 3}:
            raise SystemExit(f"phase 13: the CSVs have {chunks} chunks")

        # 4. ListObjectsV2 by pages of 100
        list_ms, listed, token = [], [], ""
        while True:
            q = {"max-keys": str(S3_PAGE), **({"continuation-token": token} if token else {})}
            t0 = time.perf_counter()
            status, body, _ = admin.list_objects(bucket, v2=True, **q)
            list_ms.append((time.perf_counter() - t0) * 1e3)
            if status != 200:
                raise SystemExit(f"phase 13: ListObjectsV2 answered {status}")
            x = parse_xml(body)
            listed += [find_text(c, "Key") for c in findall(x, "Contents")]
            token = find_text(x, "NextContinuationToken")
            if find_text(x, "IsTruncated") != "true":
                break
        if sorted(listed) != sorted(objects):
            raise SystemExit(f"phase 13: the listing has {len(listed)} keys, "
                             f"want {len(objects)}")
        out["list"] = {"keys": len(listed), "pages": len(list_ms),
                       "ms_p50": _pct(list_ms, 50), "ms_p99": _pct(list_ms, 99)}

        # 5. every object read back, ranged GETs, a presigned GET, a POST upload
        def read_all(keys: list, what: str) -> dict:
            ms, bad = {}, []

            def get(key: str) -> None:
                t0 = time.perf_counter()
                status, data, _ = admin.get_object(bucket, key)
                ms[key] = time.perf_counter() - t0
                if status != 200 or data != objects[key]:
                    bad.append((key, status, len(data)))

            sec = _parallel(get, keys, threads)
            if bad:
                raise SystemExit(f"phase 13: {len(bad)} {what} reads wrong: {bad[:5]}")
            sm = [ms[k] * 1e3 for k in keys if k in small]
            lg = [k for k in keys if k not in small]
            res = {"objects": len(keys), "s": sec, "ms_p50": _pct(sm, 50),
                   "ms_p99": _pct(sm, 99)}
            if lg:
                res["large_MBps"] = sum(len(objects[k]) for k in lg) / sum(
                    ms[k] for k in lg) / 1e6
            return res

        out["get"] = step("read_back", lambda: read_all(list(objects), "read-back"))
        rr = np.random.default_rng(1313)
        big = ["large/streamed.bin", "large/multi.bin", "csv/three.csv"]
        rng_ms, bad = [], []
        for _ in range(S3_RANGED):
            key = big[int(rr.integers(len(big)))]
            n = int(rr.integers(1, MiB))
            lo = int(rr.integers(0, len(objects[key]) - n))
            t0 = time.perf_counter()
            status, data, _ = admin.get_object(bucket, key, rng=f"bytes={lo}-{lo + n - 1}")
            rng_ms.append((time.perf_counter() - t0) * 1e3)
            if status != 206 or data != objects[key][lo:lo + n]:
                bad.append((key, lo, n, status))
        out["ranged_get"] = {"n": S3_RANGED, "ms_p50": _pct(rng_ms, 50),
                             "ms_p99": _pct(rng_ms, 99), "bad": len(bad)}
        if bad:
            raise SystemExit(f"phase 13: ranged GETs wrong: {bad[:5]}")
        url = urllib.parse.urlsplit(admin.presign("GET", f"/{bucket}/obj/00/o0000.bin"))
        status, data, _ = _call(url.netloc, "GET", f"{url.path}?{url.query}")
        if status != 200 or data != small["obj/00/o0000.bin"]:
            raise SystemExit(f"phase 13: the presigned GET answered {status}")
        form_data = rng.bytes(64 * 1024)
        form, ctype = _post_policy_form(bucket, "forms/upload.bin", form_data,
                                        "AKIA13ADMIN", "admin13secret")
        status, body, _ = _filer_call(api.url, "POST", f"/{bucket}", form,
                                      {"Content-Type": ctype})
        if status not in (200, 204) or admin.get_object(bucket, "forms/upload.bin")[1] != \
                form_data:
            raise SystemExit(f"phase 13: the POST-policy upload answered {status}: "
                             f"{body[:200]!r}")
        out["presigned_get"], out["post_policy"] = "ok", status

        # 6. the refusals: the read-only identity's write, a bad signature
        status, body, _ = reader.put_object(bucket, "denied.bin", b"nope")
        code = find_text(parse_xml(body), "Code")
        if (status, code) != (403, "AccessDenied"):
            raise SystemExit(f"phase 13: the read-only PUT answered {status} {code}")
        if reader.get_object(bucket, "obj/00/o0000.bin")[0] != 200:
            raise SystemExit("phase 13: the read-only identity could not read its bucket")
        status, body, _ = S3Client(endpoint, "AKIA13ADMIN", "not-the-secret").get_object(
            bucket, "obj/00/o0000.bin")
        bad_sig = find_text(parse_xml(body), "Code")
        if (status, bad_sig) != (403, "SignatureDoesNotMatch"):
            raise SystemExit(f"phase 13: the bad signature answered {status} {bad_sig}")
        out["refused"] = {"read_only_put": [403, code], "bad_signature": [status, bad_sig]}

        # 7. SelectObjectContent: phase 7's probe on both CSVs
        wants = {k: execute_request(v, {"input": "csv", "sql": FILER_PROBE_SQL},
                                    backend="cpu")[1]["rows"] for k, v in csvs.items()}

        def select(key: str) -> tuple[list, float, dict]:
            t0 = time.perf_counter()
            records, stats = admin.select_object_content(bucket, key, FILER_PROBE_SQL,
                                                         output_format="json")
            sec = time.perf_counter() - t0
            return [json.loads(x) for x in records.splitlines()], sec, stats

        sel = {}
        for key in csvs:
            rows, sec, stats = select(key)
            if rows != wants[key]:
                raise SystemExit(f"phase 13: Select on {key}: {len(rows)} rows, want "
                                 f"{len(wants[key])}")
            sel[key] = {"ms": sec * 1e3, "MBps": len(csvs[key]) / sec / 1e6,
                        "rows": len(rows), "bytes_scanned": stats.get("BytesScanned")}
        out["select"] = sel

        # 8. seal the volumes, lose a server, read back a seeded sample
        vids = sorted({FileId.parse(c.file_id).volume_id
                       for k in objects for c in filer.filer.find_entry(
                           f"/buckets/{bucket}/{k}").chunks})
        encodes = {}
        with _ShellCalls() as sc:
            def seal():
                for vid in vids:
                    encodes[vid] = run_command(env, f"ec.encode -volumeId={vid}")["spread"]
            step("ec_encode", seal)
        out["encode"] = {"volumes": vids, "s": steps["ec_encode"]["s"],
                         "generate_s": sc.seconds["/admin/ec/generate"],
                         "copy_s": sc.seconds["/admin/ec/copy"]}
        if any(sorted(len(x) for x in sp.values()) != [3, 3, 4, 4] for sp in encodes.values()):
            raise SystemExit(f"phase 13: the shards spread as {encodes}")
        if not _until(lambda: all(len(env.ec_shard_locations(v)) == 14
                                  and not master.master.topo.lookup("", v) for v in vids)):
            raise SystemExit("phase 13: the master never saw every volume's 14 shards")
        victim = next(t for t, sids in encodes[vids[0]].items() if sids == [1, 5, 9, 13])
        eng.stop(by_url[victim])
        stopped.add(victim)
        if not _until(lambda: not any(victim in urls for v in vids for urls in
                                      master.master.lookup_ec_volume(v)[
                                          "shard_id_locations"].values()), timeout=60):
            raise SystemExit(f"phase 13: the master still names {victim} as a shard holder")
        filer.chunk_cache = type(filer.chunk_cache)()  # every read reaches the volumes
        sample = [list(small)[int(i)] for i in np.random.default_rng(13013).choice(
            len(small), S3_SEALED_READS, replace=False)]
        out["degraded_read"] = step("degraded_read", lambda: read_all(sample, "degraded"))
        out["degraded_read"]["launches"] = steps["degraded_read"]["launches"]

        # 9. the sealed Select, traced through the gateway, the filer, a volume
        def sealed_select():
            t0 = time.perf_counter()
            status, body, hdrs = admin.request(
                "POST", f"/{bucket}/csv/one.csv", query={"select": "", "select-type": "2"},
                body=_select_xml(FILER_PROBE_SQL, "NONE"),
                headers={"Content-Type": "application/xml"})
            sec = time.perf_counter() - t0
            if status != 200:
                raise SystemExit(f"phase 13: the sealed Select answered {status}: "
                                 f"{body[:300]!r}")
            rows = [json.loads(x) for e in s3select.iter_events(body)
                    if e["headers"][":event-type"] == "Records"
                    for x in e["payload"].splitlines()]
            return rows, sec, {k.lower(): v for k, v in hdrs.items()}.get("x-sweed-trace-id", "")

        rows, sec, tid = step("sealed_select", sealed_select)
        out["sealed_select"] = {"ms": sec * 1e3, "MBps": len(csvs["csv/one.csv"]) / sec / 1e6,
                                "rows": len(rows), "launches": steps["sealed_select"]["launches"]}
        if rows != wants["csv/one.csv"]:
            raise SystemExit(f"phase 13: the sealed Select gave {len(rows)} rows, want "
                             f"{len(wants['csv/one.csv'])}")
        daemons = [(master.url, "/debug/traces"), (filer.url, "/_debug/traces")] + [
            (u, "/debug/traces") for u in by_url if u not in stopped]

        def collect() -> list:
            spans = []
            for u, route in daemons:
                spans += json.loads(_call(u, "GET", f"{route}?trace={tid}")[1])["spans"]
            return spans

        # a span reaches the ring when its request ends: hops still running
        # (a hedge's losing leg in its retry wait) leave their children
        # parentless until they end
        t0 = time.perf_counter()
        _until(lambda: len(trace_mod.assemble_tree(collect())) == 1, timeout=60)
        spans = collect()
        roots = trace_mod.assemble_tree(spans)
        uniq = {s["span_id"]: s for s in spans}
        services = sorted({s["service"] for s in uniq.values()})
        out["trace"] = {"trace_id": tid, "spans": len(uniq), "services": services,
                        "roots": len(roots), "settle_s": time.perf_counter() - t0}
        if not tid or len(roots) != 1 or roots[0]["service"] != "s3" \
                or not {"s3", "filer", "volume"} <= set(services):
            raise SystemExit(f"phase 13: the Select's trace is not one tree over the gateway, "
                             f"the filer and a volume server: {out['trace']}")
    finally:
        if api is not None:
            api.stop()
        if filer is not None:
            filer.stop()
        for url, vs in by_url.items():
            if url not in stopped:
                eng.stop(vs)
        master.stop()
    out.update(turbo=eng.totals(), steps=steps, wall_s=time.perf_counter() - t_start,
               launches=gm.gf_matmul.launches - state["l_phase"], nvidia_smi=state["smi"])
    emit(out)
    idle = [name for name in ("ec_encode", "degraded_read", "sealed_select")
            if not steps[name]["launches"]]
    if idle:
        raise SystemExit(f"phase 13: no kernel launch in {idle}")


# -- phase 14: the multi-device codec and mesh members ------------------------
MESH_DEVICES = ["cuda:0"] * 4  # a virtual 4-device mesh on the one card
MESH_BACKEND = "mesh"  # the volume servers' codec in phase 14e
MESH_COLS = 3 * GiB  # phase 2's geometry: uint8[10, 3 GiB]
MESH_DAT = GiB  # phase 4's .dat
MESH_DRYRUN = {"devices": ["cuda:0", "cuda:0"], "width": 64 * MiB}  # per rank
MESH_VOLUME_BYTES = 256 * MiB  # each member's needle mix (phase 8's sizes)
MESH_SEALED_BYTES = 64 * MiB  # the sealed plain volume of the sorted restart


@contextlib.contextmanager
def _env(**values):
    """Set environment variables for the block, then put them back."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, val in saved.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val


def _mesh_encode(state, steps: dict) -> None:
    """a. Phase 2's geometry through MeshCodec.matmul_device on the (2,2,1)
    and (2,1,2) meshes over one card, against CudaCodec's parity."""
    k, m, n = 10, 4, MESH_COLS
    dev = MESH_DEVICES[0]
    ref = get_codec(device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    data = torch.empty((k, n), dtype=torch.uint8, device=dev).random_(0, 256, generator=gen)
    want = torch.empty((m, n), dtype=torch.uint8, device=dev)
    got = torch.empty_like(want)
    ref.matmul_device(ref.parity_rows, data, out=want)
    single = cuda_ms(lambda: ref.matmul_device(ref.parity_rows, data, out=want), 3)
    res = {"shape": [k, n], "cudacodec_ms_p50": statistics.median(single),
           "cudacodec_ms_runs": single, "phase2_encode_ms_p50": state.get("phase2_encode_ms")}
    launches = 0
    for tp in (1, 2):
        mc = MeshCodec(devices=MESH_DEVICES, tp=tp)
        got.zero_()
        l0 = gm.gf_matmul.launches
        mc.matmul_device(ref.parity_rows, data, out=got)
        torch.cuda.synchronize()
        per = gm.gf_matmul.launches - l0
        equal = bool(torch.equal(got, want))
        runs = cuda_ms(lambda: mc.matmul_device(ref.parity_rows, data, out=got), 3)
        launches += gm.gf_matmul.launches - l0
        p50 = statistics.median(runs)
        name = "x".join(str(v) for v in mc.mesh.shape.values())
        res[name] = {"mesh": mc.mesh.shape, "ms_p50": p50, "ms_runs": runs,
                     "input_GBps": k * n / p50 / 1e6, "launches_per_encode": per,
                     "over_cudacodec": p50 / res["cudacodec_ms_p50"], "equal": equal}
        if not equal:
            raise SystemExit(f"phase 14a: the {name} mesh's parity differs from CudaCodec's")
    res["launches"] = launches
    del data, want, got
    torch.cuda.empty_cache()
    steps["a_encode_30GiB"] = res


def _mesh_files(state, steps: dict, mesh) -> None:
    """b. A 1 GiB .dat through write_ec_files, then rebuild_ec_files with
    {0, 3, 10, 13} lost, on the tp=2 mesh: every shard's sha256 equals the
    one CudaCodec's files have."""
    base_c, base_m = os.path.join(WORK, "14c"), os.path.join(WORK, "14m")
    rng = np.random.default_rng(14)
    with open(base_c + ".dat", "wb") as f:
        f.write(SuperBlock(version=3).to_bytes())
        left = MESH_DAT - 8
        while left:
            step = min(left, 64 * MiB)
            f.write(rng.bytes(step))
            left -= step
    os.link(base_c + ".dat", base_m + ".dat")
    t0 = time.perf_counter()
    encoder.write_ec_files(base_c, get_codec(device=MESH_DEVICES[0]))
    cuda_s = time.perf_counter() - t0
    l0, t0 = gm.gf_matmul.launches, time.perf_counter()
    stats: dict = {}
    encoder.write_ec_files(base_m, mesh, pipeline_stats=stats)
    enc_s, enc_launches = time.perf_counter() - t0, gm.gf_matmul.launches - l0
    sums = [_sha256(base_c + shard_ext(s)) for s in range(14)]
    bad = [s for s in range(14) if _sha256(base_m + shard_ext(s)) != sums[s]]
    for s in LOST:
        os.remove(base_m + shard_ext(s))
    l1, t0 = gm.gf_matmul.launches, time.perf_counter()
    rebuilt = encoder.rebuild_ec_files(base_m, mesh)
    reb_s, reb_launches = time.perf_counter() - t0, gm.gf_matmul.launches - l1
    bad_rebuilt = [s for s in LOST if _sha256(base_m + shard_ext(s)) != sums[s]]
    shard = os.path.getsize(base_m + shard_ext(0))
    steps["b_file_path"] = {
        "mesh": mesh.mesh.shape, "dat_bytes": MESH_DAT, "shard_bytes": shard,
        "cudacodec_encode_s": cuda_s, "encode_s": enc_s, "encode_GBps": MESH_DAT / enc_s / 1e9,
        "encode_efficiency": stats.get("efficiency"), "encode_launches": enc_launches,
        "rebuilt": rebuilt, "rebuild_s": reb_s, "rebuild_survivor_GBps": 10 * shard / reb_s / 1e9,
        "rebuild_launches": reb_launches, "launches": enc_launches + reb_launches,
        "shards_differ": bad, "rebuilt_differ": bad_rebuilt}
    for name in os.listdir(WORK):
        if name.startswith("14c.") or name.startswith("14m."):
            os.remove(os.path.join(WORK, name))
    if bad or bad_rebuilt or rebuilt != LOST or not enc_launches or not reb_launches:
        raise SystemExit(f"phase 14b: the mesh's shard files are wrong: {steps['b_file_path']}")


def _mesh_degraded_read(state, steps: dict, mesh) -> None:
    """c. A Store whose codec is the tp=2 mesh, 40 needles of 200-400 KB,
    shards {0, 4, 9, 12} lost and no remote reader: every needle reads back
    equal (the reference's __graft_entry__.py:138-185)."""
    d = os.path.join(WORK, "14store")
    store = Store([d], ec_backend="cuda")
    store.add_volume(10)
    rng = np.random.default_rng(140)
    blobs = {}
    for i in range(1, 41):
        blobs[i] = rng.bytes(int(rng.integers(200_000, 400_000)))
        store.write_volume_needle(10, Needle(cookie=7, id=i, data=blobs[i]))
    base = store.find_volume(10).file_name()
    store.close()
    ec_encode_volume(base, get_codec(device=MESH_DEVICES[0]))
    for ext in (".dat", ".idx"):
        os.remove(base + ext)
    for sid in (0, 4, 9, 12):
        os.remove(base + shard_ext(sid))
    store = Store([d], ec_backend="cuda")
    store._ec_codec = mesh
    wrong, ms = [], []
    l0, t0 = gm.gf_matmul.launches, time.perf_counter()
    try:
        if store.remote_shard_reader is not None or \
                len(store.find_ec_volume(10).shard_ids()) != 10:
            raise SystemExit("phase 14c: the store is not the degraded one asked for")
        for i, want in blobs.items():
            t1 = time.perf_counter()
            n = Needle(id=i)
            store.read_volume_needle(10, n)
            ms.append((time.perf_counter() - t1) * 1e3)
            if n.data != want:
                wrong.append(i)
    finally:
        store.close()
    launches = gm.gf_matmul.launches - l0
    steps["c_degraded_read"] = {"mesh": mesh.mesh.shape, "needles": len(blobs),
                                "lost": [0, 4, 9, 12], "s": time.perf_counter() - t0,
                                "read_ms_p50": _pct(ms, 50), "read_ms_p99": _pct(ms, 99),
                                "wrong": wrong, "launches": launches}
    shutil.rmtree(d, ignore_errors=True)
    if wrong or not launches:
        raise SystemExit(f"phase 14c: degraded reads wrong {wrong} or no launch ({launches})")


def _mesh_two_processes(state, steps: dict) -> None:
    """d. Two ranks over gloo share the card: make_sharded_encode with dp
    across the ranks and tp=2 in each, equal to CudaCodec's parity in the
    same rank; each rank reports its launches."""
    t0 = time.perf_counter()
    got = mesh_dryrun.run(procs=2, devices=MESH_DRYRUN["devices"], tp=2, batch=2,
                          width=MESH_DRYRUN["width"], seed=14, timeout=300)
    got["s"] = time.perf_counter() - t0
    got["launches_ranks"] = got.pop("launches")
    state["child_launches"] = state.get("child_launches", 0) + sum(got["launches_ranks"])
    steps["d_two_processes"] = got
    if got["mismatches"] or got["mesh"] != {"dp": 2, "sp": 1, "tp": 2} or \
            not all(got["launches_ranks"]):
        raise SystemExit(f"phase 14d: the two-process encode failed: {got}")


def _mesh_cluster(state, steps: dict) -> None:
    """e. The port's master and two port volume servers in this process,
    each a single-process mesh member (``SWEED_MESH=1``) with ``-ec.backend
    mesh``, one on ``-index sqlite`` and one on ``-index mmap`` (the Python
    data plane, so that the maps serve every request). Each takes 256 MiB of
    phase 8's needle mix; ``/ec/fleet/status`` lists both as initialized;
    ``ec.encode -fleet`` seals each volume on its member; a seeded 512 needles
    of each read back. Then the sqlite server restarts on ``-index sorted`` over a sealed
    plain volume, and every needle of it reads back."""
    master = MasterServer(host="127.0.0.1", port=_free_port(), node_timeout=3.0).start()
    env = CommandEnv(master.url)
    res: dict = {"servers": {}}
    servers: dict = {}
    dirs = {kind: os.path.join(WORK, f"14{kind}") for kind in ("sqlite", "mmap")}
    ports = {kind: _free_port() for kind in dirs}

    def server(kind: str, index: str) -> VolumeServer:
        return VolumeServer([dirs[kind]], host="127.0.0.1", port=ports[kind],
                            master_url=master.url, data_center=f"dc_{kind}",
                            pulse_seconds=0.5, ec_backend=MESH_BACKEND,
                            needle_map_kind=index).start()

    def read_all(blobs: dict) -> tuple[float, list]:
        wrong: list = []

        def get(item):
            fid, want = item
            status, data, _, _ = _client_get(master.url, fid)
            if status != 200 or data != want:
                wrong.append((fid, status))
        return _parallel(get, list(blobs.items()), 8), wrong

    l_start = gm.gf_matmul.launches
    try:
        with _env(SWEED_MESH="1", SWEED_TURBO="0"):
            for kind in dirs:
                servers[kind] = server(kind, kind)
            urls = {kind: f"127.0.0.1:{ports[kind]}" for kind in dirs}
            if not _until(lambda: all(
                    m.get("initialized") for m in [
                        master.fleet.members().get(u, {}) for u in urls.values()])):
                raise SystemExit(f"phase 14e: the members never reached the master: "
                                 f"{master.fleet.members()}")
            res["members"] = {u: master.fleet.members()[u] for u in urls.values()}
            cols = {"sqlite": "mesh14sqlite", "mmap": "mesh14mmap", "sealed": "mesh14sealed"}
            for name, col in cols.items():
                dc = "dc_sqlite" if name == "sealed" else f"dc_{name}"
                if _admin(master.url, f"/vol/grow?collection={col}&count=1&replication=000"
                                      f"&dataCenter={dc}") != {"count": 1}:
                    raise SystemExit(f"phase 14e: /vol/grow of {col} failed")
            blobs: dict = {}
            vids: dict = {}
            for name, col in cols.items():
                fill = MESH_SEALED_BYTES if name == "sealed" else MESH_VOLUME_BYTES
                items = _needle_blobs(141 + len(vids), fill)
                fids, _, post_ms, write_s, errors = _upload_via_master(master.url, col, items, 8)
                if errors:
                    raise SystemExit(f"phase 14e: uploads to {col} failed: {errors[:3]}")
                vids[name] = {FileId.parse(f).volume_id for f in fids}
                if len(vids[name]) != 1:
                    raise SystemExit(f"phase 14e: {col} spread over volumes {vids[name]}")
                vids[name] = vids[name].pop()
                blobs[name] = dict(zip(fids, items))
                p_ms = [x for xs in post_ms for x in xs]
                res.setdefault("upload", {})[name] = {
                    "needles": len(items), "MBps": sum(map(len, items)) / write_s / 1e6,
                    "post_ms_p50": _pct(p_ms, 50), "post_ms_p99": _pct(p_ms, 99)}
            for kind, vs in servers.items():
                v = vs.store.find_volume(vids[kind])
                res["servers"][kind] = {"url": urls[kind], "map": type(v.nm).__name__,
                                        "codec": type(vs.store.ec_codec).__name__}
            if res["servers"]["sqlite"]["map"] != "SqliteNeedleMap" or \
                    res["servers"]["mmap"]["map"] != "MmapNeedleMap":
                raise SystemExit(f"phase 14e: the needle maps are not the asked kinds: "
                                 f"{res['servers']}")
            # the fleet encode: each volume's generate on its mesh member
            jobs = {}
            l0, t0 = gm.gf_matmul.launches, time.perf_counter()
            for kind in ("sqlite", "mmap"):
                r = run_command(env, f"ec.encode -volumeId={vids[kind]} "
                                     f"-collection={cols[kind]} -fleet")
                jobs[kind] = [(j["state"], j["server"]) for j in r["jobs"]]
                if jobs[kind] != [("done", urls[kind])]:
                    raise SystemExit(f"phase 14e: the fleet encode of {kind}: {r['jobs']}")
            res["ec_encode"] = {"s": time.perf_counter() - t0, "jobs": jobs,
                                "launches": gm.gf_matmul.launches - l0}
            if not res["ec_encode"]["launches"]:
                raise SystemExit("phase 14e: the fleet encode launched no kernel")
            for kind in ("sqlite", "mmap"):
                if not _until(lambda: len(env.ec_shard_locations(vids[kind])) == 14):
                    raise SystemExit(f"phase 14e: the shards of {kind} never all mounted")
            # a seeded sample of each sealed volume (all before PR 16's cut)
            sealed = dict(kv for kind in ("sqlite", "mmap") for kv in _sample(
                sorted(blobs[kind].items()), READ_BACK_SAMPLE // 2, 1414))
            s, wrong = read_all(sealed)
            res["read_back_ec"] = {"needles": len(sealed), "s": s, "wrong": wrong[:5]}
            if wrong:
                raise SystemExit(f"phase 14e: EC read-back wrong: {wrong[:5]}")
            # the sorted restart: seal the plain volume, restart on -index sorted
            _admin(urls["sqlite"], f"/admin/readonly?volume={vids['sealed']}")
            servers.pop("sqlite").stop()
            t0 = time.perf_counter()
            servers["sqlite"] = server("sqlite", "sorted")
            v = servers["sqlite"].store.find_volume(vids["sealed"])
            if type(v.nm).__name__ != "SortedFileNeedleMap" or not v.read_only:
                raise SystemExit(f"phase 14e: the restart did not load the sorted kind: "
                                 f"{type(v.nm).__name__}")
            if not _until(lambda: master.fleet.members().get(urls["sqlite"], {}).get(
                    "initialized") and env.volume_locations(vids["sealed"])):
                raise SystemExit("phase 14e: the restarted server did not come back")
            restart_s = time.perf_counter() - t0
            s, wrong = read_all(blobs["sealed"])
            res["sorted_restart"] = {"restart_s": restart_s, "needles": len(blobs["sealed"]),
                                     "read_s": s, "wrong": wrong[:5],
                                     "sdx_bytes": os.path.getsize(v.file_name() + ".sdx")}
            if wrong:
                raise SystemExit(f"phase 14e: sorted read-back wrong: {wrong[:5]}")
    finally:
        for vs in servers.values():
            vs.stop()
        master.stop()
        for d in dirs.values():
            shutil.rmtree(d, ignore_errors=True)
    res["launches"] = gm.gf_matmul.launches - l_start
    steps["e_mesh_members"] = res


def phase14(state) -> None:
    """The multi-device codec (ec/sharded.py) and mesh membership on the one
    card: meshes that repeat ``cuda:0`` (as the JAX tests use virtual host
    devices), two ranks sharing the card over gloo, and volume servers that
    are mesh members. Every step must launch the kernel and give CudaCodec's
    bytes."""
    torch.cuda.empty_cache()
    steps: dict = {}
    mesh = MeshCodec(devices=MESH_DEVICES, tp=2)
    for name, fn in (("a", lambda: _mesh_encode(state, steps)),
                     ("b", lambda: _mesh_files(state, steps, mesh)),
                     ("c", lambda: _mesh_degraded_read(state, steps, mesh)),
                     ("d", lambda: _mesh_two_processes(state, steps)),
                     ("e", lambda: _mesh_cluster(state, steps))):
        l0, t0 = gm.gf_matmul.launches, time.perf_counter()
        fn()
        key = next(k for k in steps if k.startswith(name + "_"))
        emit({"phase": 14, "step": key, "s": time.perf_counter() - t0,
              "launches": gm.gf_matmul.launches - l0, **steps[key]})
    idle = [k for k, v in steps.items() if not (v.get("launches") or v.get("launches_ranks"))]
    emit({"phase": 14, "steps": {k: {"launches": v.get("launches", v.get("launches_ranks"))}
                                 for k, v in steps.items()},
          "launches": gm.gf_matmul.launches - state["l_phase"],
          "launches_ranks": steps["d_two_processes"]["launches_ranks"],
          "nvidia_smi": state["smi"]})
    if idle:
        raise SystemExit(f"phase 14: no kernel launch in {idle}")


RING_COL = "filer15"  # the fleet's collection
SYNC_COL = "sync15"  # the filer.sync target's own
RING_SMALL = 1024  # files of 1 KiB-1 MiB, log-uniform (phase 6's mix)
RING_DIRS = 16  # shard roots /b15/d00 ... /b15/d15
RING_CSV = (32 * MiB, 96 * MiB)  # two of the first size, one of the second
RING_DUMB = 64  # GETs and POSTs of a plain FilerClient through a non-owner
RING_PAGE = 50  # spine listing page size
RING_S3_OBJECTS = 128
RING_S3_PAGE = 100  # ListObjectsV2 max-keys
RING_SEALED_READS = 64  # small files read back after the seal (a seeded sample)
RING_THREADS = 8


def _ring_walk(url: str, root: str) -> dict:
    """{path: entry} of every file under ``root`` that the filer at ``url``
    holds itself (``noRedirect``: a fleet member's own share)."""
    from seaweedfs_tpu_torch.filer.reshard import _InternalFilerClient

    c, out, stack = _InternalFilerClient(url), {}, [root]
    while stack:
        d = stack.pop()
        cursor = ""
        while True:
            page = c.list(d, start_after=cursor, limit=1000)
            for e in page:
                p = f"{d.rstrip('/')}/{e['name']}"
                if e.get("is_directory"):
                    stack.append(p)
                else:
                    out[p] = e
            if len(page) < 1000:
                break
            cursor = page[-1]["name"]
    return out


def phase15(state) -> None:
    """The filer fleet: the port's master, four port volume servers (CUDA
    backend, ``weed volume`` defaults, the engine on), three port filers as
    one ring (the default shard depth 2, 32 MiB chunks, collection
    ``filer15`` on four volumes; stores: A sqlite, B redis over an in-process
    ``MiniRedisServer``, C ``GenericSqlStore("sqlite3")``; A publishes its
    meta events to a file queue from ``notification.toml``'s keys), the
    port's S3 gateway over ``-filer A,B,C``, and a fourth port filer E
    outside the ring (its own sqlite store and collection) as the
    ``filer.sync`` target, in one process. a. Through ``RingFilerClient``
    from 8 threads: 1 024 files (1 KiB-1 MiB) under the 16 shard roots
    ``/b15/d00`` ... ``/d15``, and phase 7's schema as two 32 MiB CSVs and
    one 96 MiB CSV in three buckets owned by three members. b. A plain
    ``FilerClient`` on one member: 64 GETs of files it does not own (307 to
    the owner), 64 POSTs it proxies, the spine ``/b15`` listed by pages of
    50 (merged across the members); the members' shares add up to every
    file written. c. 128 S3 objects PUT and GET, ListObjectsV2 by 100, and
    SelectObjectContent with phase 7's probe on a 32 MiB and the 96 MiB
    CSV, each run by its owner filer's scan on the card, rows equal to the
    cpu backend's. d. ``POST /_reshard`` moves the largest shard root to
    another member: the target's ``tree_hash`` equals the source's before,
    the source holds none of it, the target no marker, and every file reads
    back from the target. e. ``FilerSync(A, E)`` active-passive drains A's
    share of ``/b15``: every file A holds is on E with its bytes; one more
    write's lag to E; the file queue holds one event per mutation on A.
    f. ``ec.encode`` of ``filer15``'s volumes (4/4/3/3), the server with
    shards 1, 5, 9, 13 of the first stops, a seeded 64 small files read
    back through ``RingFilerClient`` and the sealed 32 MiB CSV's Select
    through the gateway, through gf_matmul."""
    from seaweedfs_tpu_torch.__main__ import _filer_notifications
    from seaweedfs_tpu_torch.filer.abstract_sql import GenericSqlStore
    from seaweedfs_tpu_torch.filer.client import FilerClient
    from seaweedfs_tpu_torch.filer.redis_store import RedisStore
    from seaweedfs_tpu_torch.filer.reshard import tree_hash
    from seaweedfs_tpu_torch.filer.ring import RingFilerClient
    from seaweedfs_tpu_torch.replication import FilerSync
    from seaweedfs_tpu_torch.replication.notification import FileQueue
    from seaweedfs_tpu_torch.s3api import S3ApiServer
    from seaweedfs_tpu_torch.s3api.s3_client import S3Client
    from seaweedfs_tpu_torch.s3api.xml_util import find_text, findall, parse_xml
    from seaweedfs_tpu_torch.util.mini_redis import MiniRedisServer

    t_start = time.perf_counter()
    n_servers, threads = 4, RING_THREADS
    dev = FILER_QUERY_BACKEND or "cuda"
    out: dict = {"phase": 15, "servers": n_servers, "filers": 3, "collection": RING_COL,
                 "chunk_MiB": FILER_CHUNK / MiB, "client_threads": threads}
    steps: dict = {}
    master = MasterServer(host="127.0.0.1", port=_free_port(), node_timeout=3.0).start()
    servers, stopped = [], set()
    for i in range(n_servers):
        servers.append(VolumeServer([os.path.join(WORK, f"15srv{i}")], host="127.0.0.1",
                                    port=_free_port(), master_url=master.url,
                                    pulse_seconds=0.5, ec_backend=EC_BACKEND))
    by_url = {f"127.0.0.1:{vs.port}": vs for vs in servers}
    eng = _Engines(15, servers)
    work = os.path.join(WORK, "15fleet")
    os.makedirs(work)
    redis = MiniRedisServer().start()
    fleet: dict = {}  # url -> FilerServer
    filer_e = api = sync_bg = None
    env = CommandEnv(master.url)
    selects: collections.Counter = collections.Counter()

    def step(name: str, fn):
        l0, e0, t0 = gm.gf_matmul.launches, TorchKernels.evaluations[dev], time.perf_counter()
        res = fn()
        steps[name] = {"s": time.perf_counter() - t0, "launches": gm.gf_matmul.launches - l0,
                       "scan_evaluations": TorchKernels.evaluations[dev] - e0}
        emit({"phase": 15, "step": name, **steps[name], **(res or {})})
        return res

    def counting(url: str, fn):
        def h_select(h, path, q, body):
            selects[url] += 1
            return fn(h, path, q, body)
        return h_select

    try:
        for vs in servers:
            vs.start()
        eng.check()
        if not _until(lambda: len(master.master.topo.data_nodes()) == n_servers):
            raise SystemExit("phase 15: the volume servers did not register")
        grown = _admin(master.url, f"/vol/grow?collection={RING_COL}&count=4&replication=000")
        if grown != {"count": 4}:
            raise SystemExit(f"phase 15: /vol/grow answered {grown}")
        ports = [_free_port() for _ in range(3)]
        ring_urls = [f"127.0.0.1:{p}" for p in ports]
        stores = {  # one store a member, so that the three run under load
            "sqlite": None,
            "redis": RedisStore(redis.address),
            "sql": GenericSqlStore("sqlite3", database=os.path.join(work, "c.sqlite"),
                                   check_same_thread=False),
        }
        for (kind, store), port in zip(stores.items(), ports):
            fs = FilerServer(host="127.0.0.1", port=port, master_url=master.url,
                             chunk_size=FILER_CHUNK, db_path=os.path.join(work, f"{kind}.db"),
                             store=store, meta_log_dir=os.path.join(work, f"{kind}.metalog"),
                             collection=RING_COL, replication="000", read_window=4,
                             write_window=4, query_backend=FILER_QUERY_BACKEND,
                             ring_peers=ring_urls)
            fs._h_select = counting(fs.url, fs._h_select)
            fleet[fs.url] = fs.start()
        a_url = ring_urls[0]
        queue_path = os.path.join(work, "a.events.jsonl")
        # notification.toml's [notification.file], by its WEED_ keys
        with _env(WEED_NOTIFICATION_FILE_ENABLED="true",
                  WEED_NOTIFICATION_FILE_PATH=queue_path):
            _filer_notifications(fleet[a_url])
        filer_e = FilerServer(host="127.0.0.1", port=_free_port(), master_url=master.url,
                              chunk_size=FILER_CHUNK, db_path=os.path.join(work, "e.db"),
                              collection=SYNC_COL, replication="000",
                              query_backend=FILER_QUERY_BACKEND).start()
        api = S3ApiServer(host="127.0.0.1", port=_free_port(),
                          filer_url=",".join(ring_urls)).start()
        s3 = S3Client(f"http://{api.url}", "", "")
        rc = RingFilerClient(ring_urls)
        ring = rc.ring
        out["ring"] = {"members": ring.members(), "depth": ring.depth,
                       "stores": dict(zip(ring_urls, stores)), "gateway": api.url,
                       "sync_target": filer_e.url}

        # the data, from the seed; the cpu backend's Select rows meanwhile
        t0 = time.perf_counter()
        rng = np.random.default_rng(15)
        files = {}
        for i in range(RING_SMALL):
            size = int(np.exp(rng.uniform(np.log(1024), np.log(MiB))))
            files[f"/b15/d{i % RING_DIRS:02d}/f{i:04d}.bin"] = rng.bytes(size)
        small = dict(files)
        owners_seen, buckets = set(), []
        for i in range(64):  # three CSV buckets owned by three members
            b = f"csv15-{i}"
            if ring.owner(f"/buckets/{b}") not in owners_seen:
                owners_seen.add(ring.owner(f"/buckets/{b}"))
                buckets.append(b)
            if len(buckets) == 3:
                break
        buckets += [f"csv15-x{i}" for i in range(3 - len(buckets))]
        one_size, three_size = RING_CSV
        csvs = {f"/buckets/{buckets[0]}/one0.csv": query_csv(150, one_size),
                f"/buckets/{buckets[1]}/one1.csv": query_csv(151, one_size),
                f"/buckets/{buckets[2]}/three.csv": query_csv(152, three_size)}
        probe = {"input": "csv", "sql": FILER_PROBE_SQL}
        pool = concurrent.futures.ThreadPoolExecutor(2)
        want_rows = {p: pool.submit(execute_request, csvs[p], probe, backend="cpu")
                     for p in (f"/buckets/{buckets[0]}/one0.csv",
                               f"/buckets/{buckets[2]}/three.csv")}
        pool.shutdown(wait=False)
        out["data_gen_s"] = time.perf_counter() - t0
        for b in ["s15", *buckets]:
            status, body, _ = s3.create_bucket(b)
            if status != 200:
                raise SystemExit(f"phase 15: CreateBucket {b} answered {status}: {body[:200]!r}")

        # a. ring writes
        def ring_writes() -> dict:
            ms, errors = [], []

            def put(path: str) -> None:
                t0 = time.perf_counter()
                try:
                    rc.put_object(path, files[path])
                except Exception as e:  # noqa: BLE001 — every failure is reported below
                    errors.append((path, repr(e)))
                ms.append((time.perf_counter() - t0) * 1e3)

            sec = _parallel(put, list(small), threads)
            if errors:
                raise SystemExit(f"phase 15: ring writes failed: {errors[:5]}")
            nbytes = sum(map(len, small.values()))
            per_member = collections.Counter(ring.owner(p) for p in small)
            t0 = time.perf_counter()
            csv_chunks = {}
            for path, data in csvs.items():
                csv_chunks[path] = rc.put_object(path, data)["chunks"]
            csv_s = time.perf_counter() - t0
            files.update(csvs)
            want_chunks = {p: -(-len(d) // FILER_CHUNK) for p, d in csvs.items()}
            if csv_chunks != want_chunks:
                raise SystemExit(f"phase 15: CSV chunks {csv_chunks}, want {want_chunks}")
            return {"files": len(small), "bytes": nbytes, "write_s": sec,
                    "MBps": nbytes / sec / 1e6,
                    "write_ms_p50": _pct(ms, 50), "write_ms_p99": _pct(ms, 99),
                    "files_per_member": {u: per_member[u] for u in ring_urls},
                    "csv": {p: ring.owner(p) for p in csvs}, "csv_s": csv_s,
                    "csv_MBps": sum(map(len, csvs.values())) / csv_s / 1e6}

        step("a_ring_writes", ring_writes)
        if len({ring.owner(p) for p in small}) < 2:
            raise SystemExit("phase 15: the shard roots did not spread over the members")

        # b. a client that does not know the ring
        def plain_client() -> dict:
            dumb_url = a_url
            dumb = FilerClient(dumb_url)
            rr = np.random.default_rng(1515)
            foreign = [p for p in small if ring.owner(p) != dumb_url]
            gets = [foreign[int(i)] for i in rr.choice(len(foreign), RING_DUMB, replace=False)]
            get_ms, post_ms, bad = [], [], []
            for p in gets:
                t0 = time.perf_counter()
                status, data, _ = dumb.get_object(p)
                get_ms.append((time.perf_counter() - t0) * 1e3)
                if status != 200 or data != files[p]:
                    bad.append(("GET", p, status))
            foreign_dirs = sorted({p.rsplit("/", 1)[0] for p in foreign})
            for i in range(RING_DUMB):
                p = f"{foreign_dirs[i % len(foreign_dirs)]}/posted{i:03d}.bin"
                body = rr.bytes(int(rr.integers(1024, 64 * 1024)))
                status, resp, sec = _filer_call(dumb_url, "POST", p, body)
                post_ms.append(sec * 1e3)
                owner = ring.owner(p)
                if status != 201 or _filer_call(owner, "GET", f"{p}?noRedirect=1")[1] != body \
                        or _filer_call(dumb_url, "GET", f"{p}?noRedirect=1")[0] != 404:
                    bad.append(("POST", p, status))
                files[p] = small[p] = body
            list_ms, names, last = [], [], ""
            while True:
                status, body, sec = _filer_call(
                    dumb_url, "GET", f"/b15/?limit={RING_PAGE}&lastFileName={last}")
                list_ms.append(sec * 1e3)
                page = json.loads(body)["entries"]
                names += [e["name"] for e in page]
                if len(page) < RING_PAGE:
                    break
                last = page[-1]["name"]
            if bad or names != [f"d{i:02d}" for i in range(RING_DIRS)]:
                raise SystemExit(f"phase 15: the plain client got {bad[:5]}, lists {names}")
            shares = {u: _ring_walk(u, "/b15") for u in ring_urls}
            held = [p for s in shares.values() for p in s]
            ring_files = sorted(p for p in files if p.startswith("/b15/"))
            if sorted(held) != ring_files:
                raise SystemExit(f"phase 15: the members hold {len(held)} files under /b15, "
                                 f"{len(set(held))} distinct, want {len(ring_files)}")
            return {"get_ms_p50": _pct(get_ms, 50), "get_ms_p99": _pct(get_ms, 99),
                    "post_ms_p50": _pct(post_ms, 50), "post_ms_p99": _pct(post_ms, 99),
                    "list_pages": len(list_ms), "list_ms_p50": _pct(list_ms, 50),
                    "list_ms_p99": _pct(list_ms, 99),
                    "members": {u: {"files": len(s), "tree_hash": tree_hash(u, "/b15")[:16]}
                                for u, s in shares.items()},
                    "files": len(held)}

        step("b_plain_client", plain_client)

        # c. S3 over the ring: objects, listing, Select on the owners' cards
        def s3_ring() -> dict:
            rr = np.random.default_rng(15015)
            objs = {f"o/{i % 8}/k{i:03d}.bin": rr.bytes(int(np.exp(rr.uniform(
                np.log(1024), np.log(MiB))))) for i in range(RING_S3_OBJECTS)}
            put_ms, get_ms, bad = [], [], []

            def put(key: str) -> None:
                t0 = time.perf_counter()
                status, body, _ = s3.put_object("s15", key, objs[key])
                put_ms.append((time.perf_counter() - t0) * 1e3)
                if status != 200:
                    bad.append(("PUT", key, status))

            def get(key: str) -> None:
                t0 = time.perf_counter()
                status, data, _ = s3.get_object("s15", key)
                get_ms.append((time.perf_counter() - t0) * 1e3)
                if status != 200 or data != objs[key]:
                    bad.append(("GET", key, status))

            put_s = _parallel(put, list(objs), threads)
            get_s = _parallel(get, list(objs), threads)
            listed, token, pages = [], "", 0
            while True:
                q = {"max-keys": str(RING_S3_PAGE),
                     **({"continuation-token": token} if token else {})}
                status, body, _ = s3.list_objects("s15", v2=True, **q)
                pages += 1
                x = parse_xml(body)
                listed += [find_text(c, "Key") for c in findall(x, "Contents")]
                token = find_text(x, "NextContinuationToken")
                if status != 200 or find_text(x, "IsTruncated") != "true":
                    break
            if bad or sorted(listed) != sorted(objs):
                raise SystemExit(f"phase 15: S3 over the ring: {bad[:5]}, "
                                 f"{len(listed)} keys listed")
            files.update({f"/buckets/s15/{k}": v for k, v in objs.items()})
            sel = {}
            for path, fut in want_rows.items():
                bucket, key = path.split("/", 3)[2:]
                before = dict(selects)
                t0 = time.perf_counter()
                records, stats = s3.select_object_content(bucket, key, FILER_PROBE_SQL,
                                                          output_format="json")
                sec = time.perf_counter() - t0
                rows = [json.loads(x) for x in records.splitlines()]
                ran_on = [u for u in ring_urls if selects[u] != before.get(u, 0)]
                want = fut.result()[1]["rows"]
                sel[path] = {"owner": ring.owner(path), "ran_on": ran_on, "ms": sec * 1e3,
                             "MBps": len(files[path]) / sec / 1e6, "rows": len(rows)}
                if rows != want or ran_on != [ring.owner(path)]:
                    raise SystemExit(f"phase 15: Select {path}: {len(rows)} rows (want "
                                     f"{len(want)}), ran on {ran_on}")
            if len({v["owner"] for v in sel.values()}) < 2:
                raise SystemExit(f"phase 15: both Selects ran on one member: {sel}")
            return {"objects": len(objs), "owner": ring.owner("/buckets/s15"),
                    "put_s": put_s, "put_ms_p50": _pct(put_ms, 50), "put_ms_p99": _pct(put_ms, 99),
                    "get_s": get_s, "get_ms_p50": _pct(get_ms, 50), "get_ms_p99": _pct(get_ms, 99),
                    "list_pages": pages, "select": sel}

        step("c_s3", s3_ring)
        if not steps["c_s3"]["scan_evaluations"]:
            raise SystemExit(f"phase 15: the Selects ran no scan on {dev}")

        # d. reshard the largest shard root to another member
        roots = collections.Counter()
        for p in small:
            roots[p.rsplit("/", 1)[0]] += len(files[p])
        root = roots.most_common(1)[0][0]
        src = ring.owner(root)
        # never onto A: step e checks that E mirrors what A holds as its owner
        dst = next(u for u in ring_urls if u not in (src, a_url))
        moved = sorted(p for p in files if p.startswith(root + "/"))

        def reshard() -> dict:
            before = tree_hash(src, root)
            t0 = time.perf_counter()
            status, body, _ = _filer_call(src, "POST",
                                          f"/_reshard?root={root}&target={dst}&epoch=15")
            sec = time.perf_counter() - t0
            if status != 200:
                raise SystemExit(f"phase 15: /_reshard answered {status}: {body[:300]!r}")
            summary = json.loads(body)
            moved_to = _ring_walk(dst, root)
            target_kv = FilerClient(dst)
            paths = [root] + sorted({p.rsplit("/", 1)[0] for p in moved_to}) + sorted(moved_to)
            sha = hashlib.sha1(root.encode()).hexdigest()
            markers = [k for k in [f"reshard.done.15.{sha}", f"reshard.ckpt.15.{sha}"] + [
                f"reshard.applied.15.{hashlib.sha1(p.encode()).hexdigest()}" for p in paths]
                if target_kv.kv_get(k) is not None]
            bad = [p for p in moved if _filer_call(dst, "GET", f"{p}?noRedirect=1")[1] != files[p]]
            left = _filer_call(src, "GET", f"{root}?meta=true&noRedirect=1")[0]
            res = {"root": root, "source": src, "target": dst, "reshard_s": sec,
                   "entries_moved": summary["applied"],
                   "entries_skipped": summary["marker_skips"] + summary["ckpt_skips"],
                   "files": len(moved), "bytes": roots[root]}
            if tree_hash(dst, root) != before or sorted(moved_to) != moved or markers or bad \
                    or left != 404:
                raise SystemExit(f"phase 15: the reshard left {res}, markers {markers[:3]}, "
                                 f"{len(bad)} files wrong, source answers {left}")
            return res

        step("d_reshard", reshard)

        # e. filer.sync of A's share of /b15 into E, and A's file queue
        def sync_and_notify() -> dict:
            sync = FilerSync(a_url, filer_e.url, source_path="/b15", target_path="/b15")
            t0, events, zeros = time.perf_counter(), 0, 0
            while zeros < 2:
                n = sync.sync_once()
                events += n
                zeros = zeros + 1 if n == 0 else 0
            drain_s = time.perf_counter() - t0
            share = _ring_walk(a_url, "/b15")
            bad = [p for p in share
                   if _filer_call(filer_e.url, "GET", p)[1] != files[p]]
            mirrored = _ring_walk(filer_e.url, "/b15")
            if bad or sorted(mirrored) != sorted(share):
                raise SystemExit(f"phase 15: E holds {len(mirrored)} files of A's "
                                 f"{len(share)}, {len(bad)} wrong")
            # one more write on A: the lag until E holds it, the sync running
            nonlocal sync_bg
            sync_bg = FilerSync(a_url, filer_e.url, source_path="/b15", target_path="/b15",
                                poll_interval=0.05).start()
            own_root = next((r for r in sorted(roots) if ring.owner(r) == a_url and r != root),
                            None) or next(f"/b15/lag{i}" for i in range(1000)
                                          if ring.owner(f"/b15/lag{i}") == a_url)
            lag_path, lag_body = f"{own_root}/lag.bin", rng.bytes(64 * 1024)
            if _filer_call(a_url, "POST", lag_path, lag_body)[0] != 201:
                raise SystemExit("phase 15: the lag probe's write failed")
            t0 = time.perf_counter()
            if not _until(lambda: _filer_call(filer_e.url, "GET", lag_path)[1] == lag_body,
                          timeout=30):
                raise SystemExit("phase 15: E never got the lag probe")
            lag_s = time.perf_counter() - t0
            files[lag_path] = lag_body
            sync_bg.stop()
            # the file queue: one event per mutation on A, in A's order
            a_events, since = [], 0
            while True:
                page = FilerClient(a_url).meta_events(since_ns=since, limit=1000)["events"]
                a_events += page
                if len(page) < 1000:
                    break
                since = page[-1]["ts_ns"]

            def queued():
                return [(r["key"], r["message"]["ts_ns"]) for r in FileQueue(queue_path).read_all()]
            want = [((e.get("new_entry") or e.get("old_entry") or {}).get("full_path"),
                     e["ts_ns"]) for e in a_events]
            if not _until(lambda: queued() == want, timeout=30):
                raise SystemExit(f"phase 15: the file queue holds {len(queued())} events, "
                                 f"A's meta log {len(want)}")
            return {"drain_s": drain_s, "events_synced": events, "files": len(share),
                    "bytes": sum(len(files[p]) for p in share),
                    "MBps": sum(len(files[p]) for p in share) / drain_s / 1e6,
                    "lag_s": lag_s, "queue_events": len(want), "stats": sync.stats()}

        step("e_sync", sync_and_notify)

        # f. seal the collection, lose a server, read back through the ring
        holder = {p: (dst if p in moved else ring.owner(p)) for p in files}
        vids = sorted({FileId.parse(c.file_id).volume_id for p in files
                       for c in fleet[holder[p]].filer.find_entry(p).chunks})
        sealed_csv = f"/buckets/{buckets[0]}/one0.csv"

        def seal() -> dict:
            encodes = {}
            with _ShellCalls() as sc:
                for vid in vids:
                    encodes[vid] = run_command(
                        env, f"ec.encode -volumeId={vid} -collection={RING_COL}")["spread"]
            if any(sorted(len(s) for s in sp.values()) != [3, 3, 4, 4]
                   for sp in encodes.values()):
                raise SystemExit(f"phase 15: the shards spread as {encodes}")
            if not _until(lambda: all(len(env.ec_shard_locations(v)) == 14
                                      and not master.master.topo.lookup(RING_COL, v)
                                      for v in vids)):
                raise SystemExit("phase 15: the master never saw every volume's 14 shards")
            victim = next(t for t, sids in encodes[vids[0]].items() if sids == [1, 5, 9, 13])
            eng.stop(by_url[victim])
            stopped.add(victim)
            if not _until(lambda: not any(victim in urls for v in vids for urls in
                                          master.master.lookup_ec_volume(v)[
                                              "shard_id_locations"].values()), timeout=60):
                raise SystemExit(f"phase 15: the master still names {victim} as a shard holder")
            for fs in fleet.values():  # every read below reaches the volume servers
                fs.chunk_cache = type(fs.chunk_cache)()
            return {"volumes": vids, "generate_s": sc.seconds["/admin/ec/generate"],
                    "copy_s": sc.seconds["/admin/ec/copy"], "victim": victim,
                    "victim_shards": {v: encodes[v].get(victim, []) for v in vids}}

        step("f_ec_encode", seal)
        readable = [p for p in small if p not in moved]
        sample = [readable[int(i)] for i in np.random.default_rng(15115).choice(
            len(readable), RING_SEALED_READS, replace=False)]

        def degraded_read() -> dict:
            ms, bad = [], []

            def get(p: str) -> None:
                t0 = time.perf_counter()
                status, data, _ = rc.get_object(p)
                ms.append((time.perf_counter() - t0) * 1e3)
                if status != 200 or data != files[p]:
                    bad.append((p, status))

            sec = _parallel(get, sample, threads)
            if bad:
                raise SystemExit(f"phase 15: sealed reads wrong: {bad[:5]}")
            return {"files": len(sample), "read_s": sec, "ms_p50": _pct(ms, 50),
                    "ms_p99": _pct(ms, 99)}

        step("f_degraded_read", degraded_read)

        def sealed_select() -> dict:
            bucket, key = sealed_csv.split("/", 3)[2:]
            t0 = time.perf_counter()
            records, _ = s3.select_object_content(bucket, key, FILER_PROBE_SQL,
                                                  output_format="json")
            sec = time.perf_counter() - t0
            rows = [json.loads(x) for x in records.splitlines()]
            want = want_rows[sealed_csv].result()[1]["rows"]
            if rows != want:
                raise SystemExit(f"phase 15: the sealed Select gave {len(rows)} rows, "
                                 f"want {len(want)}")
            return {"ms": sec * 1e3, "MBps": len(files[sealed_csv]) / sec / 1e6,
                    "rows": len(rows)}

        step("f_sealed_select", sealed_select)
        out["filer_status"] = {u: {k: v for k, v in json.loads(_filer_call(
            u, "GET", "/_status")[1]).items() if k in ("ring", "fid_leases", "hedge", "sync")}
            for u in ring_urls}
    finally:
        if sync_bg is not None:
            sync_bg.stop()
        if api is not None:
            api.stop()
        for fs in [*fleet.values(), filer_e]:
            if fs is not None:
                fs.stop()
        redis.stop()
        for url, vs in by_url.items():
            if url not in stopped:
                eng.stop(vs)
        master.stop()
    out.update(turbo=eng.totals(), steps={k: {"s": v["s"], "launches": v["launches"]}
                                          for k, v in steps.items()},
               wall_s=time.perf_counter() - t_start,
               launches=gm.gf_matmul.launches - state["l_phase"], nvidia_smi=state["smi"])
    emit(out)
    idle = [name for name in ("f_ec_encode", "f_degraded_read", "f_sealed_select")
            if not steps[name]["launches"]]
    if idle:
        raise SystemExit(f"phase 15: no kernel launch in {idle}")


GW_COL = "gw16"  # the gateways' collection
GW_DAV_FILES = 256  # WebDAV PUTs of 1 KiB-1 MiB, log-uniform (phase 6's mix)
GW_DAV_DIRS = 8
GW_FTP_FILES = 128
GW_LARGE = 64 * MiB  # the streamed WebDAV PUT, the FTP STOR, the mount's file
GW_COPY_FILES = 128  # the local tree of filer.copy
GW_FUSE_SMALL = 64
GW_MESSAGES = 8_000  # 64-1 024 B each (64 000 before a cut: PERF.md section 4)
GW_PARTITIONS = 4
GW_SEALED_READS = 32  # small files a gateway reads back after the seal
GW_THREADS = 8


def _log_uniform(rng, n: int, lo: int = 1024, hi: int = MiB) -> list:
    return [rng.bytes(int(np.exp(rng.uniform(np.log(lo), np.log(hi))))) for _ in range(n)]


def _fuse_mount(wfs, mountpoint: str, root: str):
    """``(FuseMount, None)`` once the kernel shows the mount, else ``(None,
    why)``: FUSE missing on the host, or the mount refused by it."""
    import ctypes.util
    import platform

    from seaweedfs_tpu_torch.mount.fuse_mount import FuseMount, fuse_available

    if not fuse_available():
        return None, (f"fuse_available() is false: machine {platform.machine()}, /dev/fuse "
                      f"{'present' if os.path.exists('/dev/fuse') else 'absent'}, libfuse "
                      f"{ctypes.util.find_library('fuse') or 'not found'}")
    try:
        return FuseMount(wfs, mountpoint, root=root).mount(), None
    except Exception as e:  # noqa: BLE001 — the host refused the mount: said, not hidden
        return None, f"the mount was refused: {e!r}"


def _replay(mc, partition: int) -> list:
    """(key, value) of every message of one partition of gw16/events, from 0."""
    got, since = [], 0
    while True:
        msgs, since = mc.fetch("gw16", "events", partition, since_ns=since, limit=1000)
        if not msgs:
            return got
        got += [(m["key"], m["value"]) for m in msgs]


def phase16(state) -> None:
    """The filer's client gateways: the port's master, four port volume
    servers (CUDA backend, ``weed volume`` defaults, the engine on), one port
    filer (``weed filer`` defaults: 32 MiB chunks, a sqlite ``filer.db``,
    collection ``gw16`` on four volumes), and over it the port's WebDAV
    gateway (``weed webdav`` defaults), FTP gateway (``weed ftp``, one user)
    and message broker (``weed msgBroker``), in one process. a. WebDAV from 8
    threads: MKCOL, 256 PUTs of 1 KiB-1 MiB, a streamed 64 MiB PUT, every
    file read back, PROPFIND depth 1, LOCK -> PUT with the token (and
    without: 423) -> UNLOCK, MOVE and COPY of a collection. b. FTP through
    ``ftplib`` (passive): 128 STORs and a 64 MiB one, LIST, every file
    RETR'd. c. The mount: a port ``WFS`` (``weed mount`` defaults: 8 MiB
    chunks, the meta cache on) writes a 64 MiB file by random writes of 4
    KiB-1 MiB (read-your-writes before the flush), reads it back
    sequentially and renames it; ``filer.copy`` of a local tree of 128 files
    (``copy_to_filer``, and the CLI's ``main()``); one bidirectional
    ``MountSync`` round; and, where the host has FUSE, the kernel mount: a 64
    MiB ``cp`` and 64 small ones into it, ``cat`` and ``ls`` back. d. The
    broker: 8 000 messages of 64-1 024 B published from 4 threads through
    ``MessagingClient``, one partition a thread, ``/_flush``, then every
    partition subscribed from 0: each message back in order, the count and
    md5 equal to what was published. e. ``ec.encode`` of the collection
    (4/4/3/3), the server with shards 1, 5, 9, 13 of the first stops, and a
    seeded 32 files read back through WebDAV and 32 through FTP, the 64 MiB
    file through WFS (and the 64 small files through FUSE where step c
    mounted), and one whole partition replayed from 0 through a restarted
    broker, through gf_matmul."""
    import ftplib

    from seaweedfs_tpu_torch.__main__ import main as cli_main
    from seaweedfs_tpu_torch.filer.client import FilerClient
    from seaweedfs_tpu_torch.messaging import Broker, MessagingClient
    from seaweedfs_tpu_torch.mount import WFS
    from seaweedfs_tpu_torch.mount.sync import MountSync, copy_to_filer
    from seaweedfs_tpu_torch.server.ftp_server import FtpServer
    from seaweedfs_tpu_torch.server.webdav_server import WebDavServer

    t_start = time.perf_counter()
    n_servers, threads = 4, GW_THREADS
    out: dict = {"phase": 16, "servers": n_servers, "collection": GW_COL,
                 "chunk_MiB": FILER_CHUNK / MiB, "client_threads": threads}
    steps: dict = {}
    master = MasterServer(host="127.0.0.1", port=_free_port(), node_timeout=3.0).start()
    servers, stopped = [], set()
    for i in range(n_servers):
        servers.append(VolumeServer([os.path.join(WORK, f"16srv{i}")], host="127.0.0.1",
                                    port=_free_port(), master_url=master.url,
                                    pulse_seconds=0.5, ec_backend=EC_BACKEND))
    by_url = {f"127.0.0.1:{vs.port}": vs for vs in servers}
    eng = _Engines(16, servers)
    work = os.path.join(WORK, "16gw")
    os.makedirs(work)
    filer = dav = ftp_srv = broker = None
    wfs_list: list = []
    mounts: list = []
    env = CommandEnv(master.url)

    def step(name: str, fn):
        l0, t0 = gm.gf_matmul.launches, time.perf_counter()
        res = fn()
        steps[name] = {"s": time.perf_counter() - t0, "launches": gm.gf_matmul.launches - l0}
        emit({"phase": 16, "step": name, **steps[name], **(res or {})})
        return res

    def new_wfs(**kw):
        wfs_list.append(WFS(filer.url, collection=GW_COL, **kw))
        return wfs_list[-1]

    def ftp_login():
        c = ftplib.FTP()
        c.connect(ftp_srv.host, ftp_srv.port, timeout=600)
        c.login("gw16", "haystack16")
        return c

    try:
        for vs in servers:
            vs.start()
        eng.check()
        if not _until(lambda: len(master.master.topo.data_nodes()) == n_servers):
            raise SystemExit("phase 16: the volume servers did not register")
        grown = _admin(master.url, f"/vol/grow?collection={GW_COL}&count=4&replication=000")
        if grown != {"count": 4}:
            raise SystemExit(f"phase 16: /vol/grow answered {grown}")
        filer = FilerServer(host="127.0.0.1", port=_free_port(), master_url=master.url,
                            chunk_size=FILER_CHUNK, db_path=os.path.join(work, "filer.db"),
                            collection=GW_COL, replication="000", read_window=4,
                            write_window=4, query_backend=FILER_QUERY_BACKEND).start()
        dav = WebDavServer(host="127.0.0.1", port=_free_port(), filer_url=filer.url).start()
        ftp_srv = FtpServer(host="127.0.0.1", port=_free_port(), filer_url=filer.url,
                            users={"gw16": "haystack16"}).start()
        broker = Broker(host="127.0.0.1", port=_free_port(), filer_url=filer.url).start()
        out["gateways"] = {"filer": filer.url, "webdav": dav.url, "ftp": ftp_srv.url,
                           "broker": broker.url}

        # the data, from the seed
        t0 = time.perf_counter()
        rng = np.random.default_rng(16)
        files: dict = {}  # filer path -> bytes, whichever gateway wrote it
        dav_small = {f"/dav16/d{i % GW_DAV_DIRS:02d}/f{i:04d}.bin": b
                     for i, b in enumerate(_log_uniform(rng, GW_DAV_FILES))}
        ftp_small = {f"/ftp16/g{i:04d}.bin": b
                     for i, b in enumerate(_log_uniform(rng, GW_FTP_FILES))}
        copy_tree = _log_uniform(rng, GW_COPY_FILES)
        large = {"dav": rng.bytes(GW_LARGE), "ftp": rng.bytes(GW_LARGE),
                 "wfs": rng.bytes(GW_LARGE)}
        payloads = [[(b"p%d-%06d" % (p, i), rng.bytes(int(n))) for i, n in
                     enumerate(rng.integers(64, 1025, GW_MESSAGES // GW_PARTITIONS))]
                    for p in range(GW_PARTITIONS)]
        out["data_gen_s"] = time.perf_counter() - t0

        # a. WebDAV
        def webdav() -> dict:
            d = dav.url
            for path in ["/dav16"] + [f"/dav16/d{i:02d}" for i in range(GW_DAV_DIRS)]:
                if _filer_call(d, "MKCOL", path)[0] != 201:
                    raise SystemExit(f"phase 16: MKCOL {path} refused")
            put_ms, get_ms, bad = [], [], []

            def put(path: str) -> None:
                status, _, sec = _filer_call(d, "PUT", path, dav_small[path])
                put_ms.append(sec * 1e3)
                if status != 201:
                    bad.append(("PUT", path, status))

            def get(path: str) -> None:
                status, data, sec = _filer_call(d, "GET", path)
                get_ms.append(sec * 1e3)
                if status != 200 or data != files[path]:
                    bad.append(("GET", path, status))

            put_s = _parallel(put, list(dav_small), threads)
            files.update(dav_small)
            status, _, big_put_s = _filer_call(d, "PUT", "/dav16/large.bin",
                                               io.BytesIO(large["dav"]),
                                               {"Content-Length": str(GW_LARGE)})
            if status != 201:
                raise SystemExit(f"phase 16: the streamed PUT answered {status}")
            files["/dav16/large.bin"] = large["dav"]
            status, data, big_get_s = _filer_call(d, "GET", "/dav16/large.bin")
            if status != 200 or data != large["dav"]:
                raise SystemExit(f"phase 16: the 64 MiB GET answered {status}, "
                                 f"{len(data)} bytes")
            get_s = _parallel(get, list(dav_small), threads)
            status, body, pf_s = _filer_call(d, "PROPFIND", "/dav16/d00/",
                                             headers={"Depth": "1"})
            in_d00 = sum(p.startswith("/dav16/d00/") for p in dav_small)
            if status != 207 or body.count(b"<D:response>") != in_d00 + 1:
                raise SystemExit(f"phase 16: PROPFIND answered {status}, "
                                 f"{body.count(b'<D:response>')} responses for {in_d00} files")
            # LOCK -> PUT without the token (423) and with it -> UNLOCK
            target = "/dav16/d00/f0000.bin"
            lockinfo = (b'<?xml version="1.0" encoding="utf-8"?><D:lockinfo xmlns:D="DAV:">'
                        b"<D:lockscope><D:exclusive/></D:lockscope><D:locktype><D:write/>"
                        b"</D:locktype><D:owner><D:href>phase16</D:href></D:owner></D:lockinfo>")
            conn = http.client.HTTPConnection(d, timeout=60)
            try:
                conn.request("LOCK", target, body=lockinfo, headers={"Timeout": "Second-600"})
                resp = conn.getresponse()
                resp.read()
                token = (resp.getheader("Lock-Token") or "").strip("<>")
            finally:
                conn.close()
            new_body = rng.bytes(4096)
            locked = (resp.status,
                      _filer_call(d, "PUT", target, b"refused")[0],
                      _filer_call(d, "PUT", target, new_body, {"If": f"(<{token}>)"})[0],
                      _filer_call(d, "UNLOCK", target, headers={"Lock-Token": f"<{token}>"})[0])
            if locked != (200, 423, 204, 204):
                raise SystemExit(f"phase 16: LOCK, PUT, PUT with the token, UNLOCK: {locked}")
            files[target] = dav_small[target] = new_body
            # MOVE and COPY of a collection
            last, prev = f"/dav16/d{GW_DAV_DIRS - 1:02d}", f"/dav16/d{GW_DAV_DIRS - 2:02d}"
            moved = (_filer_call(d, "MOVE", last,
                                 headers={"Destination": f"http://{d}/dav16/m"})[0],
                     _filer_call(d, "COPY", prev,
                                 headers={"Destination": f"http://{d}/dav16/c"})[0])
            if moved != (201, 201):
                raise SystemExit(f"phase 16: MOVE, COPY answered {moved}")
            for p in [p for p in dav_small if p.startswith(last + "/")]:
                files["/dav16/m/" + p.rsplit("/", 1)[1]] = dav_small.pop(p)
                del files[p]
            for p in [p for p in dav_small if p.startswith(prev + "/")]:
                files["/dav16/c/" + p.rsplit("/", 1)[1]] = dav_small[p]
            bad += [p for p in files if p.startswith(("/dav16/m/", "/dav16/c/"))
                    and _filer_call(d, "GET", p)[1] != files[p]]
            if bad:
                raise SystemExit(f"phase 16: WebDAV: {bad[:5]}")
            nbytes = sum(map(len, dav_small.values()))
            return {"files": GW_DAV_FILES, "bytes": nbytes, "put_s": put_s,
                    "put_MBps": nbytes / put_s / 1e6, "put_ms_p50": _pct(put_ms, 50),
                    "put_ms_p99": _pct(put_ms, 99), "get_s": get_s,
                    "get_ms_p50": _pct(get_ms, 50), "get_ms_p99": _pct(get_ms, 99),
                    "large_put_MBps": GW_LARGE / big_put_s / 1e6,
                    "large_get_MBps": GW_LARGE / big_get_s / 1e6,
                    "propfind_ms": pf_s * 1e3, "propfind_entries": in_d00}

        step("a_webdav", webdav)

        # b. FTP
        def ftp() -> dict:
            c = ftp_login()
            stor_ms, retr_bad = [], []
            t0 = time.perf_counter()
            for path, data in ftp_small.items():
                t1 = time.perf_counter()
                c.storbinary(f"STOR {path}", io.BytesIO(data))
                stor_ms.append((time.perf_counter() - t1) * 1e3)
            stor_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            c.storbinary("STOR /ftp16/large.bin", io.BytesIO(large["ftp"]), blocksize=MiB)
            big_stor_s = time.perf_counter() - t0
            files.update(ftp_small)
            files["/ftp16/large.bin"] = large["ftp"]
            listing: list = []
            t0 = time.perf_counter()
            c.retrlines("LIST /ftp16", listing.append)
            list_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for path, data in ftp_small.items():
                got = io.BytesIO()
                c.retrbinary(f"RETR {path}", got.write, blocksize=MiB)
                if got.getvalue() != data:
                    retr_bad.append(path)
            retr_s = time.perf_counter() - t0
            got = io.BytesIO()
            t0 = time.perf_counter()
            c.retrbinary("RETR /ftp16/large.bin", got.write, blocksize=MiB)
            big_retr_s = time.perf_counter() - t0
            c.quit()
            if retr_bad or got.getvalue() != large["ftp"] or len(listing) != GW_FTP_FILES + 1:
                raise SystemExit(f"phase 16: FTP: {len(retr_bad)} RETRs wrong, the 64 MiB "
                                 f"{len(got.getvalue())} bytes, LIST {len(listing)} lines")
            nbytes = sum(map(len, ftp_small.values()))
            return {"files": GW_FTP_FILES, "bytes": nbytes, "stor_s": stor_s,
                    "stor_MBps": nbytes / stor_s / 1e6, "stor_ms_p50": _pct(stor_ms, 50),
                    "stor_ms_p99": _pct(stor_ms, 99), "retr_MBps": nbytes / retr_s / 1e6,
                    "large_stor_MBps": GW_LARGE / big_stor_s / 1e6,
                    "large_retr_MBps": GW_LARGE / big_retr_s / 1e6, "list_ms": list_s * 1e3}

        step("b_ftp", ftp)

        # c. the mount: WFS, filer.copy, MountSync, FUSE
        def mount() -> dict:
            wfs = new_wfs()
            wfs.mkdir("/mnt16")
            rr = np.random.default_rng(1616)
            cuts = [0]
            while cuts[-1] < GW_LARGE:
                cuts.append(min(GW_LARGE, cuts[-1] + int(rr.integers(4096, MiB + 1))))
            pieces = list(zip(cuts[:-1], cuts[1:]))
            order = rr.permutation(len(pieces))
            data, path = large["wfs"], "/mnt16/random.bin"
            ryw_bad = 0
            t0 = time.perf_counter()
            with wfs.open(path, "w") as f:
                for n, i in enumerate(order):
                    lo, hi = pieces[i]
                    f.write(lo, data[lo:hi])
                    if n >= len(order) - 8:  # read-your-writes before the flush
                        ryw_bad += f.read(lo, hi - lo) != data[lo:hi]
                dirty = f.dirty.total_size()
            write_s = time.perf_counter() - t0
            chunks = len(wfs.stat(path).chunks)
            t0 = time.perf_counter()
            back = new_wfs(use_meta_cache=False).read_file(path)
            read_s = time.perf_counter() - t0
            wfs.rename(path, "/mnt16/random64.bin")
            if ryw_bad or back != data or wfs.exists(path) or \
                    wfs.stat("/mnt16/random64.bin").file_size() != GW_LARGE:
                raise SystemExit(f"phase 16: WFS: {ryw_bad} dirty reads wrong, read back "
                                 f"{len(back)} bytes, equal: {back == data}")
            files["/mnt16/random64.bin"] = data
            res = {"pieces": len(pieces), "chunks": chunks, "dirty_at_close": dirty,
                   "write_MBps": GW_LARGE / write_s / 1e6, "read_MBps": GW_LARGE / read_s / 1e6}
            # filer.copy of a local tree, by the function and by the CLI
            tree = os.path.join(work, "tree")
            for i, blob in enumerate(copy_tree):
                p = os.path.join(tree, f"s{i % 4}", f"c{i:04d}.bin")
                os.makedirs(os.path.dirname(p), exist_ok=True)
                with open(p, "wb") as fh:
                    fh.write(blob)
            t0 = time.perf_counter()
            n = copy_to_filer(tree, filer.url, "/copy16")
            copy_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            cli_main(["filer.copy", "-filer", filer.url, "-filer.path", "/copy16cli", tree])
            cli_s = time.perf_counter() - t0
            nbytes = sum(map(len, copy_tree))
            for root in ("/copy16", "/copy16cli"):
                for i, blob in enumerate(copy_tree):
                    files[f"{root}/s{i % 4}/c{i:04d}.bin"] = blob
            held = _ring_walk(filer.url, "/copy16")
            bad = [p for p in files if p.startswith(("/copy16/", "/copy16cli/"))
                   and _filer_call(filer.url, "GET", p)[1] != files[p]]
            if n != GW_COPY_FILES or len(held) != GW_COPY_FILES or bad:
                raise SystemExit(f"phase 16: filer.copy copied {n}, the filer holds "
                                 f"{len(held)}, {len(bad)} wrong")
            res.update(copy_files=n, copy_MBps=nbytes / copy_s / 1e6,
                       copy_cli_MBps=nbytes / cli_s / 1e6)
            # one bidirectional MountSync round
            local = os.path.join(work, "sync")
            t0 = time.perf_counter()
            ms = MountSync(filer.url, "/copy16", local, scan_seconds=3600).start()
            try:
                pull_s = time.perf_counter() - t0
                remote_new, local_new = rr.bytes(300_000), rr.bytes(200_000)
                wfs.write_file("/copy16/remote_new.bin", remote_new)
                with open(os.path.join(local, "local_new.bin"), "wb") as fh:
                    fh.write(local_new)
                t0 = time.perf_counter()
                sync_round = ms.sync_once()
                round_s = time.perf_counter() - t0
            finally:
                ms.stop()
            with open(os.path.join(local, "remote_new.bin"), "rb") as fh:
                pulled = fh.read()
            pushed = _filer_call(filer.url, "GET", "/copy16/local_new.bin")[1]
            # the remote file's create and its chunk commit are two events
            if pulled != remote_new or pushed != local_new or sync_round["pushed"] != 1 \
                    or not sync_round["pulled"]:
                raise SystemExit(f"phase 16: the MountSync round gave {sync_round}")
            files.update({"/copy16/remote_new.bin": remote_new,
                          "/copy16/local_new.bin": local_new})
            res.update(sync_materialize_s=pull_s, sync_round_s=round_s)
            # the kernel's FUSE mount, where the host has it
            wfs.mkdir("/fuse16")
            mp = os.path.join(work, "fuse")
            fm, why = _fuse_mount(new_wfs(), mp, "/fuse16")
            if fm is None:
                res["fuse"] = {"ran": False, "why": why}
                return res
            mounts.append(fm)
            src = os.path.join(work, "fuse_src")
            os.makedirs(src)
            with open(os.path.join(src, "big.bin"), "wb") as fh:
                fh.write(large["dav"])
            smalls = {f"m{i:03d}.bin": blob for i, blob in enumerate(copy_tree[:GW_FUSE_SMALL])}
            for name, blob in smalls.items():
                with open(os.path.join(src, name), "wb") as fh:
                    fh.write(blob)
            os.makedirs(os.path.join(mp, "small"))
            t0 = time.perf_counter()
            r1 = subprocess.run(["cp", os.path.join(src, "big.bin"), mp], capture_output=True)
            cp_s = time.perf_counter() - t0
            r2 = subprocess.run(["cp", *[os.path.join(src, n) for n in smalls],
                                 os.path.join(mp, "small")], capture_output=True)
            t0 = time.perf_counter()
            cat = subprocess.run(["cat", os.path.join(mp, "big.bin")], capture_output=True)
            cat_s = time.perf_counter() - t0
            listed = sorted(os.listdir(os.path.join(mp, "small")))
            small_bad = []
            for name, blob in smalls.items():
                with open(os.path.join(mp, "small", name), "rb") as fh:
                    if fh.read() != blob:
                        small_bad.append(name)
            mounts.remove(fm)
            fm.unmount()
            if r1.returncode or r2.returncode or cat.stdout != large["dav"] or small_bad \
                    or listed != sorted(smalls) or os.path.ismount(mp):
                raise SystemExit(f"phase 16: FUSE: cp {r1.returncode}/{r2.returncode} "
                                 f"{r1.stderr[-200:]!r}, cat {len(cat.stdout)} bytes, "
                                 f"{len(small_bad)} small files wrong, ls {len(listed)}")
            files["/fuse16/big.bin"] = large["dav"]
            files.update({f"/fuse16/small/{n}": b for n, b in smalls.items()})
            res["fuse"] = {"ran": True, "cp_MBps": GW_LARGE / cp_s / 1e6,
                           "cat_MBps": GW_LARGE / cat_s / 1e6, "small_files": len(smalls)}
            return res

        fuse_ran = step("c_mount", mount)["fuse"]["ran"]

        # d. the broker
        published = {}

        def pubsub() -> dict:
            mc = MessagingClient([broker.url])
            mc.create_topic("gw16", "events", partitions=GW_PARTITIONS)
            errors = []

            def pub(p: int) -> None:
                try:
                    for key, value in payloads[p]:
                        mc.publish("gw16", "events", value, key=key, partition=p)
                except Exception as e:  # noqa: BLE001 — every failure is reported below
                    errors.append((p, repr(e)))

            pub_s = _parallel(pub, list(range(GW_PARTITIONS)), GW_PARTITIONS)
            if errors:
                raise SystemExit(f"phase 16: publishes failed: {errors}")
            if _filer_call(broker.url, "POST", "/_flush")[0] != 200:
                raise SystemExit("phase 16: /_flush refused")
            for tp in list(broker.topics._partitions.values()):
                for t in list(tp.buffer._flushers):  # every segment on the filer
                    t.join(timeout=120)
            t0 = time.perf_counter()
            got = {p: _replay(mc, p) for p in range(GW_PARTITIONS)}
            fetch_s = time.perf_counter() - t0
            for p in range(GW_PARTITIONS):
                published[p] = hashlib.md5(b"".join(v for _, v in payloads[p])).hexdigest()
                if got[p] != payloads[p]:
                    raise SystemExit(f"phase 16: partition {p}: {len(got[p])} messages back "
                                     f"of {len(payloads[p])}")
            segs = {p: len(FilerClient(filer.url).list(f"/topics/gw16/events/{p:02d}"))
                    for p in range(GW_PARTITIONS)}
            nbytes = sum(len(v) for msgs in payloads for _, v in msgs)
            return {"messages": GW_MESSAGES, "bytes": nbytes, "publish_s": pub_s,
                    "publish_msgs_per_s": GW_MESSAGES / pub_s,
                    "fetch_msgs_per_s": GW_MESSAGES / fetch_s, "segments": segs,
                    "md5": published}

        step("d_broker", pubsub)

        # e. seal, lose a server, read back through every gateway
        walked = _ring_walk(filer.url, "/")
        vids = sorted({FileId.parse(c["file_id"]).volume_id for e in walked.values()
                       for c in e.get("chunks", [])})

        def seal() -> dict:
            encodes = {}
            with _ShellCalls() as sc:
                for vid in vids:
                    encodes[vid] = run_command(
                        env, f"ec.encode -volumeId={vid} -collection={GW_COL}")["spread"]
            if any(sorted(len(s) for s in sp.values()) != [3, 3, 4, 4]
                   for sp in encodes.values()):
                raise SystemExit(f"phase 16: the shards spread as {encodes}")
            if not _until(lambda: all(len(env.ec_shard_locations(v)) == 14
                                      and not master.master.topo.lookup(GW_COL, v)
                                      for v in vids)):
                raise SystemExit("phase 16: the master never saw every volume's 14 shards")
            victim = next(t for t, sids in encodes[vids[0]].items() if sids == [1, 5, 9, 13])
            eng.stop(by_url[victim])
            stopped.add(victim)
            if not _until(lambda: not any(victim in urls for v in vids for urls in
                                          master.master.lookup_ec_volume(v)[
                                              "shard_id_locations"].values()), timeout=60):
                raise SystemExit(f"phase 16: the master still names {victim} as a shard holder")
            filer.chunk_cache = type(filer.chunk_cache)()  # every read reaches the servers
            return {"volumes": vids, "files": len(walked),
                    "generate_s": sc.seconds["/admin/ec/generate"],
                    "copy_s": sc.seconds["/admin/ec/copy"], "victim": victim,
                    "victim_shards": {v: encodes[v].get(victim, []) for v in vids}}

        step("e_ec_encode", seal)
        pick = np.random.default_rng(16016)
        dav_sample = sorted(pick.choice(sorted(dav_small), GW_SEALED_READS, replace=False))
        ftp_sample = sorted(pick.choice(sorted(ftp_small), GW_SEALED_READS, replace=False))

        def sealed_webdav() -> dict:
            t0 = time.perf_counter()
            bad = [p for p in dav_sample if _filer_call(dav.url, "GET", p)[1] != files[p]]
            sec = time.perf_counter() - t0
            if bad:
                raise SystemExit(f"phase 16: sealed WebDAV reads wrong: {bad[:5]}")
            return {"files": len(dav_sample), "read_s": sec,
                    "bytes": sum(len(files[p]) for p in dav_sample)}

        def sealed_ftp() -> dict:
            c, bad = ftp_login(), []
            t0 = time.perf_counter()
            for p in ftp_sample:
                got = io.BytesIO()
                c.retrbinary(f"RETR {p}", got.write, blocksize=MiB)
                if got.getvalue() != files[p]:
                    bad.append(p)
            sec = time.perf_counter() - t0
            c.quit()
            if bad:
                raise SystemExit(f"phase 16: sealed FTP reads wrong: {bad[:5]}")
            return {"files": len(ftp_sample), "read_s": sec,
                    "bytes": sum(len(files[p]) for p in ftp_sample)}

        def sealed_wfs() -> dict:
            t0 = time.perf_counter()
            back = new_wfs(use_meta_cache=False).read_file("/mnt16/random64.bin")
            sec = time.perf_counter() - t0
            if back != files["/mnt16/random64.bin"]:
                raise SystemExit(f"phase 16: the sealed WFS read gave {len(back)} bytes, "
                                 "not the file")
            return {"bytes": len(back), "read_s": sec, "MBps": len(back) / sec / 1e6}

        def sealed_fuse() -> dict:
            # the small files, not the 64 MiB one: each 128 KiB kernel read
            # refetches its whole 8 MiB chunk, rebuilt anew once sealed (a
            # cut: PERF.md section 4)
            mp = os.path.join(work, "fuse")
            fm, why = _fuse_mount(new_wfs(), mp, "/fuse16")
            if fm is None:  # it mounted in step c: a refusal now is a failure
                raise SystemExit(f"phase 16: the FUSE remount failed: {why}")
            mounts.append(fm)
            names = sorted(p.rsplit("/", 1)[1] for p in files if p.startswith("/fuse16/small/"))
            t0 = time.perf_counter()
            cat = subprocess.run(["cat", *names], cwd=os.path.join(mp, "small"),
                                 capture_output=True)
            sec = time.perf_counter() - t0
            listed = sorted(os.listdir(os.path.join(mp, "small")))
            mounts.remove(fm)
            fm.unmount()
            want = b"".join(files[f"/fuse16/small/{n}"] for n in names)
            if cat.returncode or cat.stdout != want or listed != names:
                raise SystemExit(f"phase 16: the sealed FUSE read gave {len(cat.stdout)} "
                                 f"bytes of {len(want)}: {cat.stderr[-200:]!r}")
            return {"files": len(names), "bytes": len(want), "read_s": sec}

        def sealed_broker() -> dict:
            nonlocal broker
            broker.stop()  # a fresh broker holds nothing in memory: every read is a segment's
            broker = Broker(host="127.0.0.1", port=_free_port(), filer_url=filer.url).start()
            t0 = time.perf_counter()
            got = _replay(MessagingClient([broker.url]), 0)
            sec = time.perf_counter() - t0
            md5 = hashlib.md5(b"".join(v for _, v in got)).hexdigest()
            if got != payloads[0] or md5 != published[0]:
                raise SystemExit(f"phase 16: the sealed replay of partition 0 gave "
                                 f"{len(got)} messages of {len(payloads[0])}")
            return {"partition": 0, "messages": len(got), "read_s": sec, "md5": md5}

        step("e_sealed_webdav", sealed_webdav)
        step("e_sealed_ftp", sealed_ftp)
        step("e_sealed_wfs", sealed_wfs)
        if fuse_ran:
            step("e_sealed_fuse", sealed_fuse)
        step("e_sealed_broker", sealed_broker)
    finally:
        for fm in mounts:
            fm.unmount()
        for w in wfs_list:
            w.close()
        for srv in (broker, ftp_srv, dav, filer):
            if srv is not None:
                srv.stop()
        for url, vs in by_url.items():
            if url not in stopped:
                eng.stop(vs)
        master.stop()
    sealed = {k: v["launches"] for k, v in steps.items() if k.startswith("e_sealed_")}
    out.update(turbo=eng.totals(), steps={k: {"s": v["s"], "launches": v["launches"]}
                                          for k, v in steps.items()},
               sealed_read_launches=sealed, wall_s=time.perf_counter() - t_start,
               launches=gm.gf_matmul.launches - state["l_phase"], nvidia_smi=state["smi"])
    emit(out)
    if not steps["e_ec_encode"]["launches"] or not sum(sealed.values()):
        raise SystemExit(f"phase 16: no kernel launch in the seal or the sealed reads: "
                         f"{out['steps']}")


P17_FILES = 1024  # files of 1 KiB-1 MiB, log-uniform (phase 6's mix), printable text
P17_DIRS = 16  # /p17/d00 ... /p17/d15
P17_CSV = 32 * MiB  # one CSV of phase 7's schema: one 32 MiB chunk, pushed down
P17_ORPHANS = 16  # needles written with /dir/assign and a POST, no filer entry
P17_SEALED_CATS = 64  # files of a sealed volume read with fs.cat
P17_LOST = [1, 5, 9, 13]
P17_THREADS = 8
P17_MAX = 14  # the server's -max (weed server's 7, doubled: a cut, PERF.md section 4)
P17_SERVER_FLAGS: list = []  # e.g. ["-ec.backend", "cpu"] to rehearse on the CPU
P17_ENV: dict = {}  # e.g. {"SWEED_QUERY_BACKEND": "cpu"} to rehearse on the CPU


class _Cli:
    """``python -m seaweedfs_tpu_torch`` runs, each to its end and timed;
    one that exits non-zero fails the phase."""

    def __init__(self, cwd: str, env: dict, phase: int = 17):
        self.cwd, self.env = cwd, dict(os.environ, PYTHONPATH=HERE, **env)
        self.phase = phase

    def run(self, *args) -> tuple:
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch", *args], cwd=self.cwd,
                           env=self.env, capture_output=True, text=True, timeout=600)
        sec = time.perf_counter() - t0
        if r.returncode != 0:
            raise SystemExit(f"phase {self.phase}: {' '.join(args)[:200]} exited {r.returncode}: "
                             f"{(r.stdout + r.stderr)[-1500:]}")
        return r, sec

    def shell(self, master: str, filer: str, command: str) -> tuple:
        """One ``shell -c`` batch: (stdout, seconds)."""
        r, sec = self.run("shell", "-master", master, "-filer", filer, "-c", command)
        return r.stdout, sec


class _ShellSession:
    """``shell -master M -filer F`` on a pipe, a command at a time: each
    reply is read to its known length and the next prompt, so a command's
    time is the operator's, without a process start."""

    def __init__(self, cli: _Cli, master: str, filer: str):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "shell", "-master", master,
             "-filer", filer], cwd=cli.cwd, env=cli.env, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
        got = b""
        while not got.endswith(b"> "):  # the banner, then the first prompt
            piece = self.proc.stdout.read1(1 << 16)
            if not piece:
                raise SystemExit(f"phase 17: the shell session ended: {got[-300:]!r}")
            got += piece

    def _expect(self, want: bytes) -> None:
        got = self.proc.stdout.read(len(want))
        if got != want:
            raise SystemExit(f"phase 17: the shell printed {len(got)} bytes that differ "
                             f"from the {len(want)} expected: {got[-200:]!r}")

    def cat(self, path: str, want: bytes) -> float:
        """``fs.cat path``: its seconds; fails unless it printed ``want``."""
        t0 = time.perf_counter()
        self.proc.stdin.write(f"fs.cat {path}\n".encode())
        self.proc.stdin.flush()
        self._expect(want + b"\n> ")
        return time.perf_counter() - t0

    def close(self) -> None:
        try:
            self.proc.stdin.close()
            self.proc.wait(timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            self.proc.kill()
            self.proc.wait()


def _json_docs(text: str) -> list:
    """The JSON values a ``shell -c`` batch printed, one after another."""
    dec, docs, i = json.JSONDecoder(), [], 0
    while i < len(text):
        if text[i].isspace():
            i += 1
            continue
        value, i = dec.raw_decode(text, i)
        docs.append(value)
    return docs


def _printable(rng, n: int) -> list:
    """Phase 6's mix of sizes as printable text, so that ``fs.cat`` prints
    the bytes as they were written."""
    sizes = [int(np.exp(rng.uniform(np.log(1024), np.log(MiB)))) for _ in range(n)]
    return [rng.integers(32, 127, s, dtype=np.uint8).tobytes() for s in sizes]


def phase17(state) -> None:
    """The operator's tools: ``python -m seaweedfs_tpu_torch -cpuprofile=P
    server -dir D -max 14 -filer -s3 -webdav`` as a subprocess on the card
    (ports from ``util/netports``; ``weed server``'s defaults but ``-max``).
    a. the stack starts. b. through the filer from 8 threads: 1 024 text
    files of phase 6's sizes under ``/p17/d00``-``/d15``, a 32 MiB CSV of
    phase 7's schema, and 16 orphans (``/dir/assign`` and a POST, no filer
    entry). c. ``shell -master M -filer F -c ...`` batches: ``fs.cd``,
    ``fs.pwd``, ``fs.ls``, ``fs.du``, ``fs.tree``, ``fs.cat``, ``fs.mv``,
    ``fs.meta.cat``, ``fs.meta.save``; ``fs.configure -locationPrefix=/p17/
    cold/ -collection=cold17 -apply`` and a write that lands in ``cold17``;
    ``bucket.create``/``list``/``delete`` with the bucket seen through the S3
    port between; ``volume.fsck`` listing exactly the 16 orphans, and with
    ``-apply`` purging none (inside its 300 s cutoff). d. the stand-alone
    ``ec.encode -master M -volume N`` of the CSV's volume (14 shards, .ecx,
    .vif); the shell's ``ec.encode`` of the filer's volumes but one, kept
    plain; shards {1, 5, 9, 13} deleted on the CSV's volume and on the
    volume with the most small files (the filer mints fids from leases of
    128 keys a volume, so they gather on a few); then in one shell session
    ``fs.cat`` of a seeded 64 files of that volume (bytes equal), ``query``
    with phase 12's probe on the CSV (rows equal to the cpu backend's) and
    ``trace`` of that query. e. the server stopped by SIGTERM (its cpu
    profile loads with ``pstats``), then on its data directory: ``dump.idx
    -ext .ecx`` of the sealed fs.cat volume, ``dump.dat`` and ``export`` of
    the plain one, ``fix`` of a copy without its .idx (the .idx equal to the
    original), ``change.superblock -replication=001`` and back, ``scaffold
    -config=security`` and ``version``. The server's kernel launches (its
    volume server's ``/status``) count to the main path."""
    import pstats

    from seaweedfs_tpu_torch.util import netports

    t_start = time.perf_counter()
    work = os.path.join(WORK, "17op")
    data_dir = os.path.join(work, "data")
    os.makedirs(data_dir)
    ports = netports.load_or_allocate(os.path.join(work, "ports.json"),
                                      ["master", "volume", "filer", "s3", "webdav"])
    urls = {k: f"127.0.0.1:{p}" for k, p in ports.items()}
    murl, vurl, furl = urls["master"], urls["volume"], urls["filer"]
    profile = os.path.join(work, "server.prof")
    cli = _Cli(work, P17_ENV)
    out: dict = {"phase": 17, "ports": ports, "client_threads": P17_THREADS,
                 "server_flags": ["-max", str(P17_MAX), *P17_SERVER_FLAGS]}
    steps: dict = {}
    shell_ms: list = []
    server = session = None
    log = open(os.path.join(work, "server.log"), "wb")

    def status() -> dict:
        code, body, _ = _call(vurl, "GET", "/status")
        if code != 200:
            raise SystemExit(f"phase 17: the volume server's /status answered {code}")
        return json.loads(body)

    def launches() -> int:
        return status()["gf_matmul"]["launches"]

    def step(name: str, fn):
        l0, t0 = state["p17_launches"], time.perf_counter()
        res = fn() or {}
        if server is not None and server.poll() is None:
            state["p17_launches"] = launches()
        steps[name] = {"s": time.perf_counter() - t0,
                       "launches": state["p17_launches"] - l0}
        emit({"phase": 17, "step": name, **steps[name], **res})
        return res

    def sh(command: str) -> str:
        stdout, sec = cli.shell(murl, furl, command)
        shell_ms.append(sec * 1e3 / (command.count(";") + 1))
        return stdout

    state["p17_launches"] = 0
    try:
        # a. the stack
        def start() -> dict:
            nonlocal server
            server = subprocess.Popen(
                [sys.executable, "-m", "seaweedfs_tpu_torch", f"-cpuprofile={profile}",
                 "server", "-dir", "data", "-master.port", str(ports["master"]),
                 "-port", str(ports["volume"]), "-max", str(P17_MAX),
                 "-filer", "-filer.port", str(ports["filer"]),
                 "-s3", "-s3.port", str(ports["s3"]),
                 "-webdav", "-webdav.port", str(ports["webdav"]), *P17_SERVER_FLAGS],
                cwd=work, env=cli.env, stdout=log, stderr=subprocess.STDOUT)

            def up() -> bool:
                if server.poll() is not None:
                    raise SystemExit(f"phase 17: the server exited {server.returncode}")
                try:
                    return (_call(furl, "GET", "/_status")[0] == 200
                            and _call(urls["webdav"], "OPTIONS", "/")[0] < 500
                            and _call(urls["s3"], "GET", "/")[0] == 200
                            and bool(json.loads(_call(murl, "GET", "/dir/status")[1])[
                                "topology"]["data_centers"]))
                except OSError:
                    return False

            if not _until(up, timeout=120):
                raise SystemExit("phase 17: the server never came up")
            netports.record(os.path.join(work, "ports.json"), ports)
            st = status()
            state["p17_launches"] = st["gf_matmul"]["launches"]
            return {"turbo": st["turbo"]["on"], "launches_at_start": state["p17_launches"]}

        step("a_start", start)

        # b. the fill
        rng = np.random.default_rng(17)
        files = {f"/p17/d{i % P17_DIRS:02d}/f{i:04d}.txt": b
                 for i, b in enumerate(_printable(rng, P17_FILES))}
        csv_path, csv = "/p17/data.csv", query_csv(1717, P17_CSV)
        orphans: set = set()

        def fill() -> dict:
            put_ms, bad = [], []

            def put(path: str) -> None:
                status, _, sec = _filer_call(furl, "POST", path, files[path])
                put_ms.append(sec * 1e3)
                if status != 201:
                    bad.append((path, status))

            put_s = _parallel(put, list(files), P17_THREADS)
            status, _, csv_s = _filer_call(furl, "POST", csv_path, csv)
            if bad or status != 201:
                raise SystemExit(f"phase 17: the fill failed: {bad[:5]}, csv {status}")
            for i in range(P17_ORPHANS):
                a = json.loads(_call(murl, "GET", "/dir/assign")[1])
                if _call(a["url"], "POST", "/" + a["fid"], rng.bytes(512 + 64 * i))[0] != 201:
                    raise SystemExit(f"phase 17: the orphan {a['fid']} was refused")
                vid, rest = a["fid"].split(",")
                orphans.add((int(vid), int(rest[:-8], 16)))
            nbytes = sum(map(len, files.values()))
            return {"files": len(files), "bytes": nbytes, "put_s": put_s,
                    "MBps": nbytes / put_s / 1e6, "put_ms_p50": _pct(put_ms, 50),
                    "put_ms_p99": _pct(put_ms, 99), "csv_MBps": len(csv) / csv_s / 1e6,
                    "orphans": len(orphans)}

        step("b_fill", fill)

        def volume_of(path: str) -> int:
            meta = json.loads(_call(furl, "GET", path + "?meta=true")[1])
            return int(meta["chunks"][0]["file_id"].split(",")[0])

        # c. the shell
        cat_path = "/p17/d00/f0000.txt"
        moved_from = sorted(p for p in files if p.startswith("/p17/d15/"))[0]
        moved_to = "/p17/moved/" + moved_from.rsplit("/", 1)[1]

        def shell_tools() -> dict:
            lines = sh("fs.cd /p17; fs.pwd; fs.ls").splitlines()
            listed = json.loads("\n".join(lines[2:]))
            if lines[:2] != ["/p17", "/p17"] or sorted(e["name"] for e in listed) != \
                    sorted([f"d{i:02d}" for i in range(P17_DIRS)] + ["data.csv"]):
                raise SystemExit(f"phase 17: fs.cd/pwd/ls printed {lines[:4]}")
            du = json.loads(sh("fs.du /p17"))
            want_du = {"path": "/p17", "bytes": sum(map(len, files.values())) + len(csv),
                       "files": len(files) + 1, "dirs": P17_DIRS}
            if du != want_du:
                raise SystemExit(f"phase 17: fs.du gave {du}, not {want_du}")
            tree = sh("fs.tree /p17/d03").splitlines()
            in_d03 = sorted(p.rsplit("/", 1)[1] for p in files if p.startswith("/p17/d03/"))
            if tree[0] != "/p17/d03" or [t[4:] for t in tree[1:]] != in_d03:
                raise SystemExit(f"phase 17: fs.tree printed {tree[:3]}")
            if sh(f"fs.cat {cat_path}") != files[cat_path].decode() + "\n":
                raise SystemExit("phase 17: fs.cat printed other bytes")
            mv = sh(f"fs.mv {moved_from} {moved_to}; fs.meta.cat {moved_to}")
            moved, meta = _json_docs(mv)
            if moved != {"moved": moved_from, "to": moved_to} \
                    or meta["full_path"] != moved_to \
                    or sum(c["size"] for c in meta["chunks"]) != len(files[moved_from]):
                raise SystemExit(f"phase 17: fs.mv/fs.meta.cat printed {mv[:300]}")
            files[moved_to] = files.pop(moved_from)
            dump = os.path.join(work, "meta.jsonl")
            saved = json.loads(sh(f"fs.meta.save -o={dump} /p17"))
            if saved != {"saved": len(files) + 1, "file": dump}:
                raise SystemExit(f"phase 17: fs.meta.save gave {saved}")
            return {"batches": len(shell_ms), "tree_entries": len(tree) - 1,
                    "meta_saved": saved["saved"]}

        step("c_fs", shell_tools)

        def configure() -> dict:
            conf = json.loads(sh("fs.configure -locationPrefix=/p17/cold/ -collection=cold17 "
                                 "-apply"))
            if {"location_prefix": "/p17/cold/", "collection": "cold17"}.items() - \
                    conf["locations"][0].items():
                raise SystemExit(f"phase 17: fs.configure gave {conf}")
            body = rng.bytes(4096)

            def landed() -> bool:
                if _filer_call(furl, "POST", "/p17/cold/x.bin", body)[0] != 201:
                    return False
                vid = volume_of("/p17/cold/x.bin")
                return any(v["id"] == vid and v["collection"] == "cold17"
                           for v in status()["volumes"])

            if not _until(landed, timeout=30):
                raise SystemExit("phase 17: a write under /p17/cold/ never landed in cold17")
            if _filer_call(furl, "GET", "/p17/cold/x.bin")[1] != body:
                raise SystemExit("phase 17: the cold17 write read back other bytes")
            return {"cold_volume": volume_of("/p17/cold/x.bin")}

        step("c_configure", configure)

        def buckets() -> dict:
            made = _json_docs(sh("bucket.create -name=b17; bucket.list"))
            s3_list = _call(urls["s3"], "GET", "/")[1]
            gone = _json_docs(sh("bucket.delete -name=b17; bucket.list"))
            s3_after = _call(urls["s3"], "GET", "/")[1]
            if made != [{"created": "b17"}, ["b17"]] or b"<Name>b17</Name>" not in s3_list \
                    or gone != [{"deleted": "b17"}, []] or b"<Name>b17</Name>" in s3_after:
                raise SystemExit(f"phase 17: buckets: {made} {s3_list[:300]!r} {gone}")
            return {"s3_listed": True}

        step("c_buckets", buckets)

        def fsck() -> dict:
            t0 = time.perf_counter()
            found = json.loads(sh("volume.fsck"))
            fsck_s = time.perf_counter() - t0
            got = {(o["vid"], o["key"]) for o in found["orphans"]}
            if got != orphans or found["purged"] != 0:
                raise SystemExit(f"phase 17: volume.fsck listed {sorted(got)[:20]}, "
                                 f"planted {sorted(orphans)[:20]}")
            applied = json.loads(sh("volume.fsck -apply=true"))
            if applied["purged"] != 0 or len(applied["orphans"]) != P17_ORPHANS:
                raise SystemExit(f"phase 17: volume.fsck -apply purged {applied['purged']}")
            scanned = sum(v["file_count"] for v in status()["volumes"])
            return {"orphans": len(got), "fsck_s": fsck_s, "needles_scanned": scanned,
                    "needles_per_s": scanned / fsck_s, "apply_purged": applied["purged"]}

        step("c_fsck", fsck)
        out["shell_ms_p50"] = _pct(shell_ms, 50)

        # d. the seal
        vol_of: dict = {}

        def locate(path: str) -> None:
            vol_of[path] = volume_of(path)

        _parallel(locate, [*files, csv_path], P17_THREADS)
        csv_vid = vol_of[csv_path]
        by_vid = collections.Counter(vol_of[p] for p in files)
        # the filer mints fids from leases of 128 keys on one volume each,
        # so the small files gather on a few volumes: the fs.cat sample
        # comes from the one with the most, which loses shards too
        cat_vid = by_vid.most_common(1)[0][0]
        # one volume of the filer's collection stays plain for the offline
        # tools: the fullest that is neither of those two
        plain_vid = max((v["id"] for v in status()["volumes"] if v["collection"] == ""
                         and v["id"] not in (csv_vid, cat_vid)),
                        key=lambda v: (by_vid[v], v))

        def standalone_encode() -> dict:
            r, sec = cli.run("ec.encode", "-master", murl, "-volume", str(csv_vid))
            made = set(os.listdir(data_dir))
            want = {f"{csv_vid}{shard_ext(i)}" for i in range(14)} | \
                {f"{csv_vid}.ecx", f"{csv_vid}.vif"}
            if "error" in r.stdout or not want <= made:
                raise SystemExit(f"phase 17: ec.encode printed {r.stdout[:300]}; "
                                 f"missing {sorted(want - made)}")
            return {"volume": csv_vid, "cli_s": sec, "files_by_volume": dict(by_vid)}

        step("d_ec_encode_cli", standalone_encode)
        seal = sorted((set(by_vid) | {csv_vid}) - {plain_vid})
        lost = sorted({csv_vid, cat_vid})

        def shell_encode() -> dict:
            stdout = sh("; ".join(f"ec.encode -volumeId={v}" for v in seal))
            vols = {v["id"] for v in status()["volumes"]}
            if vols & set(seal) or stdout.count('"spread"') != len(seal):
                raise SystemExit(f"phase 17: the shell's ec.encode left {vols & set(seal)}")
            for vid in lost:
                removed = _admin(vurl, f"/admin/ec/delete_shards?volume={vid}"
                                       f"&shards={','.join(map(str, P17_LOST))}")
                if removed.get("removed") != P17_LOST:
                    raise SystemExit(f"phase 17: delete_shards of {vid} removed {removed}")
            return {"volumes": seal, "plain_volume": plain_vid, "shards_lost": P17_LOST,
                    "on_volumes": lost}

        step("d_ec_encode_shell", shell_encode)
        # cat_path was read in step c: the filer's chunk cache holds it
        on_vid = sorted(p for p in files if p != cat_path and vol_of[p] == cat_vid)
        pick = np.random.default_rng(17017)
        sample = sorted(pick.choice(on_vid, min(P17_SEALED_CATS, len(on_vid)), replace=False))

        def sealed_cat() -> dict:
            nonlocal session
            session = _ShellSession(cli, murl, furl)
            ms = [session.cat(p, files[p]) * 1e3 for p in sample]
            session.close()
            session = None
            return {"volume": cat_vid, "files": len(ms),
                    "bytes": sum(len(files[p]) for p in sample),
                    "ms_p50": _pct(ms, 50), "ms_p99": _pct(ms, 99)}

        res = step("d_sealed_cat", sealed_cat)
        out["sealed_cat"] = {**res, "launches": steps["d_sealed_cat"]["launches"]}
        want_rows = execute_request(csv, {"input": "csv", "sql": FILER_PROBE_SQL},
                                    backend="cpu")[1]["rows"]

        def sealed_query() -> dict:
            stdout, sec = cli.shell(murl, furl, f'query -path={csv_path} "{FILER_PROBE_SQL}"')
            rows = json.loads(stdout)["rows"]
            if rows != want_rows:
                raise SystemExit(f"phase 17: the sealed query gave {len(rows)} rows, the cpu "
                                 f"backend {len(want_rows)}")
            return {"rows": len(rows), "query_ms": sec * 1e3}

        step("d_sealed_query", sealed_query)

        def trace() -> dict:
            spans = json.loads(_call(furl, "GET", "/_debug/traces?limit=4096")[1])["spans"]
            roots = [s for s in spans if not s.get("parent_id") and "_query" in s["name"]]
            if not roots:
                raise SystemExit("phase 17: no /_query root span in the filer's ring")
            tid = max(roots, key=lambda s: s["start"])["trace_id"]
            got = json.loads(sh(f"trace {tid}"))
            if got["trace_id"] != tid or got["span_count"] < 2 or got["unreachable"]:
                raise SystemExit(f"phase 17: trace gave {got}")
            return {"trace_id": tid, "spans": got["span_count"],
                    "daemons_queried": got["daemons_queried"]}

        step("d_trace", trace)

        # e. the offline tools, the server stopped
        def stop() -> dict:
            nonlocal server
            state["p17_launches"] = launches()
            server.send_signal(signal.SIGTERM)
            code = server.wait(timeout=120)
            server = None
            if code not in (0, 143, -signal.SIGTERM):
                raise SystemExit(f"phase 17: the server exited {code} on SIGTERM")
            stats = pstats.Stats(profile)
            return {"exit": code, "profile_bytes": os.path.getsize(profile),
                    "profile_functions": len(stats.stats)}

        step("e_stop", stop)

        def offline() -> dict:
            tools: dict = {}
            plain = os.path.join(data_dir, str(plain_vid))
            size = os.path.getsize(plain + ".dat")

            def tool(name: str, *args, nbytes: int = size, cwd_dir: str = data_dir) -> str:
                r, sec = cli.run(name, "-dir", cwd_dir, *args)
                tools[name if name not in tools else f"{name}2"] = {
                    "s": sec, "MBps": nbytes / sec / 1e6}
                return r.stdout

            ecx = tool("dump.idx", "-volumeId", str(cat_vid), "-ext", ".ecx",
                       nbytes=os.path.getsize(os.path.join(data_dir, f"{cat_vid}.ecx")))
            dat = tool("dump.dat", "-volumeId", str(plain_vid))
            tar = os.path.join(work, "export.tar")
            exp = tool("export", "-volumeId", str(plain_vid), "-o", tar)
            fixdir = os.path.join(work, "fix")
            os.makedirs(fixdir)
            shutil.copy(plain + ".dat", fixdir)
            fixed = tool("fix", "-volumeId", str(plain_vid), cwd_dir=fixdir)
            fixed_equal = _sha256(os.path.join(fixdir, f"{plain_vid}.idx")) == \
                _sha256(plain + ".idx")
            sb = tool("change.superblock", "-volumeId", str(plain_vid), "-replication=001",
                      cwd_dir=fixdir)
            back = tool("change.superblock", "-volumeId", str(plain_vid), cwd_dir=fixdir)
            scaffold, sec = cli.run("scaffold", "-config=security")
            version, _ = cli.run("version")
            tools["scaffold"] = {"s": sec}
            with tarfile.open(tar) as tf:
                members = len(tf.getmembers())
            live = sum(vol_of[p] == plain_vid for p in files)
            n_ecx = int(ecx.strip().rsplit("# ", 1)[1].split()[0])
            checks = {
                "ecx_entries": n_ecx >= by_vid[cat_vid],
                "dat_records": "# " in dat and "records" in dat.splitlines()[-1],
                "export_members": members >= live,
                "fix_idx_equal": fixed_equal and "fixed" in fixed,
                "superblock": "Changing replication to: 001" in sb
                and "Current Volume Replication: 001" in back,
                "scaffold": "[jwt.signing]" in scaffold.stdout,
                "version": version.stdout.startswith("seaweedfs_tpu_torch "),
                "exported": exp.startswith("exported "),
            }
            if not all(checks.values()):
                raise SystemExit(f"phase 17: offline tools: {checks}")
            return {"tools": tools, "volume_bytes": size, "ecx_entries": n_ecx,
                    "export_members": members}

        res = step("e_offline", offline)
        out["offline"] = res["tools"]
    except BaseException:
        if os.path.exists(os.path.join(work, "server.log")):
            log.flush()
            with open(os.path.join(work, "server.log"), "rb") as f:
                sys.stderr.write(f.read()[-4000:].decode("utf-8", "replace"))
        raise
    finally:
        if session is not None:
            session.close()
        if server is not None and server.poll() is None:
            server.send_signal(signal.SIGTERM)
            try:
                server.wait(timeout=60)
            except subprocess.TimeoutExpired:
                server.kill()
                server.wait()
        log.close()
    state["child_launches"] = state.get("child_launches", 0) + state["p17_launches"]
    out.update(steps={k: {"s": v["s"], "launches": v["launches"]} for k, v in steps.items()},
               wall_s=time.perf_counter() - t_start, launches=state["p17_launches"],
               nvidia_smi=state["smi"])
    emit(out)
    if not steps["d_ec_encode_shell"]["launches"] + steps["d_sealed_cat"]["launches"]:
        raise SystemExit(f"phase 17: no kernel launch in the seal or the sealed reads: "
                         f"{out['steps']}")


P18_FILES = 256  # files of 1 KiB-1 MiB, log-uniform (phase 6's mix)
P18_DIRS = 8  # /p18/d0 ... /p18/d7
P18_READS = 64  # files of the fullest sealed volume read back (a seeded sample)
P18_LOST = [1, 5, 9, 13]
P18_THREADS = 8
P18_MAX = 7  # weed server's -max
P18_SERVER_FLAGS: list = []  # e.g. ["-ec.backend", "cpu"] to rehearse on the CPU
P18_ENV: dict = {}  # e.g. {"SWEED_QUERY_BACKEND": "cpu"} to rehearse on the CPU
# The edges the CPU cross-checks (tests/torch_port/test_torch_lock_order.py
# and test_torch_racecheck.py) recorded when this phase was written: phase
# 18 prints the edges it sees beyond them, the ones only the card's paths
# take. A report, not a check: the check is static ⊇ dynamic.
P18_CPU_EDGES = frozenset(tuple(e.split(" -> ")) for e in (
    "DiskLocation._lock -> DiskFile._lock", "DiskLocation._lock -> Volume._lock",
    "EcJobScheduler._lock -> Histogram._lock", "Filer._lock -> MetaLog._lock",
    "LifecycleController._lock -> Histogram._lock", "Master._lock -> MemorySequencer._lock",
    "Master._lock -> Topology._lock", "Master._lock -> VolumeLayout._lock",
    "MasterServer._lock -> Master._lock", "MasterServer._lock -> MemorySequencer._lock",
    "MasterServer._lock -> Topology._lock", "MasterServer._lock -> VolumeLayout._lock",
    "NeedleCache._resize_mu -> NeedleCache._Shard._lock", "Store._lock -> DiskFile._lock",
    "Store._lock -> EwmaHeat._lock", "TenantGovernor._mu -> TokenBucket._mu",
    "TopicManager._lock -> LogBuffer._lock", "Topology._lock -> VolumeLayout._lock",
    "Volume._lock -> DiskFile._lock"))
P18_GAUGES = ("sweed_lock_acquisitions_total", "sweed_lock_contended_total",
              "sweed_lock_max_held_depth", "sweed_lock_order_edges")


def _static_graph(out: dict) -> None:
    """The port analyzer's lock-order edges and race candidates over
    ``seaweedfs_tpu_torch/`` (one project, one lock-graph build) into
    ``out``; an exception goes there too."""
    import ast

    from seaweedfs_tpu_torch.analysis import _iter_py_files
    from seaweedfs_tpu_torch.analysis.callgraph import Project
    from seaweedfs_tpu_torch.analysis.racecheck import RaceChecker

    t0 = time.perf_counter()
    try:
        proj = Project()
        for path, rel in _iter_py_files(os.path.join(HERE, "seaweedfs_tpu_torch")):
            with open(path, encoding="utf-8") as f:
                src = f.read()
            proj.add_module(rel, ast.parse(src), src.splitlines())
        rc = RaceChecker(proj)
        out["edges"] = rc.lb.graph.edge_set()
        out["races"] = {c.name for c in rc.race_candidates()}
    except Exception as e:  # noqa: BLE001 — reported by the phase
        out["error"] = repr(e)
    out["s"] = time.perf_counter() - t0


def phase18(state) -> None:
    """The sanitizers on the card: ``python -m seaweedfs_tpu_torch server -dir
    D -max 7 -filer`` as a subprocess with ``SWEED_LOCK_CHECK=1``,
    ``SWEED_RACE_CHECK=1`` and their dumps (``weed server``'s defaults
    otherwise: the CUDA backend, the engine on). The port analyzer's static
    graph over ``seaweedfs_tpu_torch/`` is computed here while it starts.
    a. the stack starts. b. 256 files of phase 6's mix through the filer
    from 8 threads. c. the shell's ``ec.encode`` of the filer's volumes,
    shards {1, 5, 9, 13} dropped on the fullest. d. a seeded 64 of its files
    read back through the filer from 8 threads, byte for byte, so locks
    contend on the kernel's path. e. ``/dir/status``, ``/_status`` and
    ``/metrics``: the lock counters non-zero, the four ``sweed_lock_*``
    gauges there. f. SIGTERM: the dumps are written at exit. The checks: no
    ``LockOrderError`` and a clean exit; acquisitions and at least one
    edge; every observed edge in the static graph and every race
    observation among the static candidates; the kernel launched (the
    server's ``/status``, counted to the main path)."""
    from seaweedfs_tpu_torch.util import netports

    t_start = time.perf_counter()
    work = os.path.join(WORK, "18san")
    data_dir = os.path.join(work, "data")
    os.makedirs(data_dir)
    ports = netports.load_or_allocate(os.path.join(work, "ports.json"),
                                      ["master", "volume", "filer"])
    murl, vurl, furl = (f"127.0.0.1:{ports[k]}" for k in ("master", "volume", "filer"))
    lock_dump, race_dump = os.path.join(work, "locks.json"), os.path.join(work, "races.json")
    cli = _Cli(work, {"SWEED_LOCK_CHECK": "1", "SWEED_RACE_CHECK": "1",
                      "SWEED_LOCK_DUMP": lock_dump, "SWEED_RACE_DUMP": race_dump, **P18_ENV},
               phase=18)
    out: dict = {"phase": 18, "ports": ports, "client_threads": P18_THREADS,
                 "server_flags": ["-max", str(P18_MAX), *P18_SERVER_FLAGS]}
    steps: dict = {}
    static: dict = {}
    analyzer = threading.Thread(target=_static_graph, args=(static,))
    analyzer.start()
    server = None
    log_path = os.path.join(work, "server.log")
    log = open(log_path, "wb")

    def status() -> dict:
        code, body, _ = _call(vurl, "GET", "/status")
        if code != 200:
            raise SystemExit(f"phase 18: the volume server's /status answered {code}")
        return json.loads(body)

    def step(name: str, fn):
        l0, t0 = state["p18_launches"], time.perf_counter()
        res = fn() or {}
        if server is not None and server.poll() is None:
            state["p18_launches"] = status()["gf_matmul"]["launches"]
        steps[name] = {"s": time.perf_counter() - t0,
                       "launches": state["p18_launches"] - l0}
        emit({"phase": 18, "step": name, **steps[name], **res})
        return res

    state["p18_launches"] = 0
    try:
        def start() -> dict:
            nonlocal server
            server = subprocess.Popen(
                [sys.executable, "-m", "seaweedfs_tpu_torch", "server", "-dir", "data",
                 "-master.port", str(ports["master"]), "-port", str(ports["volume"]),
                 "-max", str(P18_MAX), "-filer", "-filer.port", str(ports["filer"]),
                 *P18_SERVER_FLAGS],
                cwd=work, env=cli.env, stdout=log, stderr=subprocess.STDOUT)

            def up() -> bool:
                if server.poll() is not None:
                    raise SystemExit(f"phase 18: the server exited {server.returncode}")
                try:
                    return (_call(furl, "GET", "/_status")[0] == 200
                            and bool(json.loads(_call(murl, "GET", "/dir/status")[1])[
                                "topology"]["data_centers"]))
                except OSError:
                    return False

            if not _until(up, timeout=120):
                raise SystemExit("phase 18: the server never came up")
            netports.record(os.path.join(work, "ports.json"), ports)
            st = status()
            state["p18_launches"] = st["gf_matmul"]["launches"]
            return {"turbo": st["turbo"]["on"], "launches_at_start": state["p18_launches"]}

        step("a_start", start)

        rng = np.random.default_rng(18)
        files = {f"/p18/d{i % P18_DIRS}/f{i:03d}.bin": b
                 for i, b in enumerate(_log_uniform(rng, P18_FILES))}

        def fill() -> dict:
            put_ms, bad = [], []

            def put(path: str) -> None:
                code, _, sec = _filer_call(furl, "POST", path, files[path])
                put_ms.append(sec * 1e3)
                if code != 201:
                    bad.append((path, code))

            put_s = _parallel(put, list(files), P18_THREADS)
            if bad:
                raise SystemExit(f"phase 18: the fill failed: {bad[:5]}")
            nbytes = sum(map(len, files.values()))
            return {"files": len(files), "bytes": nbytes, "put_s": put_s,
                    "MBps": nbytes / put_s / 1e6, "put_ms_p50": _pct(put_ms, 50),
                    "put_ms_p99": _pct(put_ms, 99)}

        fill_res = step("b_fill", fill)
        vol_of: dict = {}

        def locate(path: str) -> None:
            meta = json.loads(_call(furl, "GET", path + "?meta=true")[1])
            vol_of[path] = int(meta["chunks"][0]["file_id"].split(",")[0])

        _parallel(locate, list(files), P18_THREADS)
        by_vid = collections.Counter(vol_of.values())
        fullest = by_vid.most_common(1)[0][0]

        def seal() -> dict:
            seal_vids = sorted(by_vid)
            stdout, sec = cli.shell(murl, furl,
                                    "; ".join(f"ec.encode -volumeId={v}" for v in seal_vids))
            left = {v["id"] for v in status()["volumes"]} & set(seal_vids)
            if left or stdout.count('"spread"') != len(seal_vids):
                raise SystemExit(f"phase 18: the shell's ec.encode left {left}: {stdout[:300]}")
            removed = _admin(vurl, f"/admin/ec/delete_shards?volume={fullest}"
                                   f"&shards={','.join(map(str, P18_LOST))}")
            if removed.get("removed") != P18_LOST:
                raise SystemExit(f"phase 18: delete_shards of {fullest} removed {removed}")
            return {"volumes": seal_vids, "shell_s": sec, "fullest": fullest,
                    "files_on_fullest": by_vid[fullest], "shards_lost": P18_LOST}

        step("c_seal", seal)
        on_fullest = sorted(p for p in files if vol_of[p] == fullest)
        sample = sorted(np.random.default_rng(1818).choice(
            on_fullest, min(P18_READS, len(on_fullest)), replace=False))

        def sealed_reads() -> dict:
            ms, bad = [], []

            def get(path: str) -> None:
                code, body, sec = _filer_call(furl, "GET", path)
                ms.append(sec * 1e3)
                if code != 200 or body != files[path]:
                    bad.append((path, code, len(body)))

            get_s = _parallel(get, sample, P18_THREADS)
            if bad:
                raise SystemExit(f"phase 18: sealed reads differ: {bad[:5]}")
            nbytes = sum(len(files[p]) for p in sample)
            return {"files": len(sample), "bytes": nbytes, "get_s": get_s,
                    "MBps": nbytes / get_s / 1e6, "ms_p50": _pct(ms, 50),
                    "ms_p99": _pct(ms, 99)}

        step("d_sealed_reads", sealed_reads)

        def counters() -> dict:
            got = {"master": json.loads(_call(murl, "GET", "/dir/status")[1])["locks"],
                   "filer": json.loads(_call(furl, "GET", "/_status")[1])["locks"]}
            gauges = {}
            for line in _call(murl, "GET", "/metrics")[1].decode().splitlines():
                name, _, value = line.partition(" ")
                if name in P18_GAUGES:
                    gauges[name] = float(value)
            bad = [k for k, v in got.items()
                   if not (v["enabled"] and v["acquisitions"] > 0 and v["max_held_depth"] > 0)]
            if bad or set(gauges) != set(P18_GAUGES) or \
                    gauges["sweed_lock_acquisitions_total"] <= 0:
                raise SystemExit(f"phase 18: lock counters {got if bad else ''} gauges {gauges}")
            return {"status_acquisitions": got["master"]["acquisitions"],
                    "status_contended": got["master"]["contended"],
                    "status_edges": len(got["master"]["edges"]), "gauges": gauges}

        step("e_counters", counters)

        def stop() -> dict:
            nonlocal server
            state["p18_launches"] = status()["gf_matmul"]["launches"]
            server.send_signal(signal.SIGTERM)
            code = server.wait(timeout=120)
            server = None
            if code not in (0, 143):
                raise SystemExit(f"phase 18: the server exited {code} on SIGTERM")
            return {"exit": code}

        step("f_stop", stop)
    except BaseException:
        log.flush()
        with open(log_path, "rb") as f:
            sys.stderr.write(f.read()[-4000:].decode("utf-8", "replace"))
        raise
    finally:
        if server is not None and server.poll() is None:
            server.send_signal(signal.SIGTERM)
            try:
                server.wait(timeout=60)
            except subprocess.TimeoutExpired:
                server.kill()
                server.wait()
        log.close()
        analyzer.join()
    state["child_launches"] = state.get("child_launches", 0) + state["p18_launches"]

    with open(log_path, "rb") as f:
        inversions = f.read().count(b"LockOrderError")
    if not (os.path.exists(lock_dump) and os.path.exists(race_dump)):
        raise SystemExit("phase 18: the server wrote no sanitizer dump at exit")
    with open(lock_dump) as f:
        locks = json.load(f)
    with open(race_dump) as f:
        races = json.load(f)["observations"]
    if "error" in static:
        raise SystemExit(f"phase 18: the static analysis failed: {static['error']}")
    dynamic = {tuple(e.split(" -> ")) for e in locks["edges"]}
    missing = sorted(dynamic - static["edges"])
    race_missing = sorted({o["name"] for o in races} - static["races"])
    out.update(
        acquisitions=locks["acquisitions"], contended=locks["contended"],
        max_held_depth=locks["max_held_depth"], edges=len(dynamic),
        edges_only_on_card=[" -> ".join(e) for e in sorted(dynamic - P18_CPU_EDGES)],
        observations=races, inversions=inversions, static_edges=len(static["edges"]),
        static_races=len(static["races"]), static_s=static["s"],
        fill_MBps_sanitized=fill_res["MBps"],
        steps={k: {"s": v["s"], "launches": v["launches"]} for k, v in steps.items()},
        wall_s=time.perf_counter() - t_start, launches=state["p18_launches"],
        nvidia_smi=state["smi"])
    emit(out)
    if inversions or not locks["enabled"] or locks["acquisitions"] <= 0 or not dynamic:
        raise SystemExit(f"phase 18: sanitizer run: {inversions} LockOrderError(s), "
                         f"{locks['acquisitions']} acquisitions, {len(dynamic)} edges")
    if missing or race_missing:
        raise SystemExit(f"phase 18: observed but not in the static graph: edges {missing}, "
                         f"race observations {race_missing}; first sites "
                         f"{ {k: v for k, v in locks['edge_sites'].items() if tuple(k.split(' -> ')) in missing} }")
    if not steps["c_seal"]["launches"] + steps["d_sealed_reads"]["launches"]:
        raise SystemExit(f"phase 18: no kernel launch in the seal or the sealed reads: "
                         f"{out['steps']}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


MAIN_PATH = (phase2, phase3, phase4, phase5, phase6, phase7, phase8, phase9, phase10,
             phase11, phase12, phase13, phase14, phase15, phase16, phase17, phase18)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU", file=sys.stderr)
        return 2
    state: dict = {}
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        phase0(state)
        phase1(state)
        gm.gf_matmul.launches = 0  # the main path starts here
        phase_s = {}
        for i, phase in enumerate(MAIN_PATH, start=2):
            state["l_phase"] = gm.gf_matmul.launches
            children = state.get("child_launches", 0)
            t0 = time.perf_counter()
            phase(state)
            phase_s[i] = time.perf_counter() - t0
            # a phase's launches: this process's, and those its child
            # processes counted and reported (phase 14's ranks, phase 17's
            # and phase 18's servers)
            if gm.gf_matmul.launches == state["l_phase"] and \
                    state.get("child_launches", 0) == children:
                raise SystemExit(f"phase {i}: the kernel was never launched")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    # the launches of phase 14's child ranks and phase 17's and 18's
    # servers, counted in their processes
    main_launches = gm.gf_matmul.launches + state.get("child_launches", 0)
    kern = state["kernel"]
    emit({"phase_s": phase_s})
    print(smi_line(), flush=True)
    emit({"kernels": [{
        "name": "gf_matmul", "route": "cuda",
        "source": "seaweedfs_tpu_torch/csrc/gf_matmul.cu",
        "replaces": "seaweedfs_tpu/ec/codec.py:207",
        "launches": main_launches, "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"], "library_ms": None,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
