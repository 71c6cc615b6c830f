"""Command line: ``python -m seaweedfs_tpu_torch
master|volume|shell|backup|compact|volume.tail|benchmark ...``.

- ``master`` runs a master with the flags of ``weed master``: ``-ip -port
  -volumeSizeLimitMB -defaultReplication -peers -mdir``. ``-peers A,B,C``
  (this master's own address among them) elects one leader of the set;
  ``-mdir D`` keeps the vote, the fid-lease journal and the autopilot's plan
  journal there across restarts. ``SWEED_LIFECYCLE=1`` runs the autopilot on
  the leader (``cluster/lifecycle.py`` lists its ``SWEED_LIFECYCLE_*`` and
  ``SWEED_TIER_*`` knobs).
- ``volume`` runs a volume server with the flags of ``weed volume`` (and of
  the JAX package's CLI): ``-ip -port -dir -mserver -dataCenter -rack -max
  -pulseSeconds -index``. ``-ec.backend`` is ``cuda`` (the default: the
  hand-written kernel, and EC requests fail without a card) or ``cpu`` (the
  kernel's plain PyTorch version).
- ``shell`` runs the admin shell against ``-master``; ``-c "cmd; cmd"``
  runs the commands and exits 1 if one failed.
- ``backup -master -volume -dir [-collection]`` makes or brings up to date
  a local copy of a volume (`weed backup`): one incremental pass.
- ``compact -dir -volumeId [-collection]`` compacts a volume offline
  (`weed compact`).
- ``volume.tail -master -volumeId`` follows a volume's appended needles
  through ``/admin/tail``: ``+`` lines for writes, ``-`` for deletes.
- ``benchmark -master -n -c -size -collection -assign.batch -deletePercent``
  is `weed benchmark`: writes ``-n`` files of ``-size`` bytes from ``-c``
  keep-alive connections (fids from count-batched assigns), optionally
  deletes a share, reads the rest back, and reports requests/s and latency
  percentiles per phase.

The daemons run until SIGINT or SIGTERM, then stop cleanly.
"""

from __future__ import annotations

import argparse
import signal
import threading
import time


def _positive_pulse(s: str) -> float:
    val = float(s)
    if val < 0.1:
        raise argparse.ArgumentTypeError(
            "pulseSeconds must be >= 0.1 (0 would busy-spin the beat loop)")
    return val


def _serve_until_signalled(server) -> None:
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    try:
        stop.wait()
    finally:
        server.stop()


def cmd_master(args) -> None:
    from .server.master_server import MasterServer

    peers = [p.strip() for p in args.peers.split(",") if p.strip()]
    ms = MasterServer(
        host=args.ip,
        port=args.port,
        volume_size_limit_mb=args.volume_size_limit_mb,
        default_replication=args.default_replication,
        peers=peers or None,
        meta_dir=args.mdir or None,
    ).start()
    print(f"master listening on {ms.url}", flush=True)
    _serve_until_signalled(ms)


def cmd_shell(args) -> None:
    from .shell.shell import run_shell

    run_shell(args.master, command=args.command)


def cmd_backup(args) -> None:
    from .storage.volume_backup import backup_volume

    r = backup_volume(args.master, args.volume, args.dir, args.collection)
    print(f"volume {r['volume']} <- {r['from']}: +{r['writes']} writes, "
          f"+{r['deletes']} deletes (now {r['file_count']} files)")


def cmd_compact(args) -> None:
    from .storage.volume import Volume

    v = Volume(args.dir, collection=args.collection, vid=args.volume_id,
               create_if_missing=False)
    try:
        before = v.size()
        v.compact()
        after = v.size()
    finally:
        v.close()
    print(f"volume {args.volume_id}: {before} -> {after} bytes "
          f"({before - after} reclaimed)")


def cmd_volume_tail(args) -> None:
    """Follow a volume's appended needles (the reference's volume_tailer,
    `unmaintained/volume_tailer/volume_tailer.go:24`). ``-rewind=-1``
    starts at the first entry, 0 at now, N at N seconds back; it stops
    after ``-timeoutSeconds`` without news (0 follows for ever)."""
    import gzip
    import time

    from .server.http_util import http_bytes_headers, http_json
    from .storage.volume_backup import parse_tail_frames
    from .util.parsers import tolerant_uint

    locs = http_json("GET", f"http://{args.master}/dir/lookup?volumeId={args.volume_id}"
                     ).get("locations", [])
    if not locs:
        raise SystemExit(f"volume {args.volume_id} not found on any server")
    src = locs[0]["url"]
    if args.rewind < 0:
        since = 0
    elif args.rewind == 0:
        since = time.time_ns()
    else:
        since = time.time_ns() - int(args.rewind * 1e9)
    idle_start = time.monotonic()
    while True:
        status, blob, headers = http_bytes_headers(
            "GET", f"http://{src}/admin/tail?volume={args.volume_id}&since_ns={since}")
        if status != 200:
            raise SystemExit(f"tail {src}: HTTP {status}")
        if not blob:
            if args.timeout_seconds and time.monotonic() - idle_start > args.timeout_seconds:
                return
            time.sleep(args.poll_interval)
            continue
        idle_start = time.monotonic()
        version = tolerant_uint(headers.get("X-Volume-Version", "3"), 3)
        for n in parse_tail_frames(blob, version):
            mark = "-" if n.size <= 0 else "+"
            print(f"{mark} {args.volume_id},{n.id:x}{n.cookie:08x} "
                  f"size {max(n.size, 0)} appendedAt {n.append_at_ns}")
            if args.show_text and n.size > 0:
                data = n.data
                if n.is_compressed:
                    try:
                        data = gzip.decompress(data)
                    except OSError:
                        continue  # a bad gzip body is not printed
                try:
                    print(data.decode("utf-8"))
                except UnicodeDecodeError:
                    pass
        since = tolerant_uint(headers.get("X-Last-Append-Ns", since), since)


class _BenchPump:
    """Single-threaded event-loop HTTP/1.1 load generator.

    The reference's benchmark client is compiled Go with goroutine workers
    (weed/command/benchmark.go:196); 16 Python threads spend more time in
    GIL handoffs than in requests.  One selectors loop with `concurrency`
    keep-alive sockets (one in-flight request each, so per-request latency
    stays honest) drives the turbo data plane at event-loop cost.

    The port's copy of the JAX package's load generator."""

    def __init__(self, concurrency: int):
        import selectors

        self.sel = selectors.DefaultSelector()
        self.concurrency = concurrency
        self.latencies: list[float] = []
        self.failures = 0

    def _connect(self, addr):
        import socket

        host, port = addr.split(":")
        s = socket.create_connection((host, int(port)))
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # blocking: sendall must complete even past the kernel buffer;
        # recv only runs after select says readable, so it never blocks long
        return s

    def run(self, jobs) -> float:
        """jobs: iterator of (addr, request_bytes). Returns wall seconds."""
        import socket

        slots = []  # [addr, sock, buf, t0, need, busy]
        for _ in range(self.concurrency):
            slots.append({"addr": None, "sock": None, "buf": b"", "t0": 0.0,
                          "busy": False})
        it = iter(jobs)
        pending = True
        inflight = 0
        t_start = time.perf_counter()

        def feed(slot):
            # loop so a send failure consumes the next job on a fresh
            # connection instead of permanently parking this slot
            nonlocal pending, inflight
            while True:
                if not pending:
                    return False
                try:
                    addr, req = next(it)
                except StopIteration:
                    pending = False
                    return False
                try:
                    if slot["addr"] != addr or slot["sock"] is None:
                        if slot["sock"] is not None:
                            self.sel.unregister(slot["sock"])
                            slot["sock"].close()
                            slot["sock"] = None
                        slot["sock"] = self._connect(addr)
                        slot["addr"] = addr
                        import selectors

                        self.sel.register(slot["sock"], selectors.EVENT_READ,
                                          slot)
                    slot["buf"] = b""
                    slot["t0"] = time.perf_counter()
                    slot["req"] = req
                    slot["sock"].sendall(req)
                except OSError:
                    self.failures += 1
                    if slot["sock"] is not None:
                        try:
                            self.sel.unregister(slot["sock"])
                        except KeyError:
                            pass
                        slot["sock"].close()
                        slot["sock"] = None
                    continue  # job counted failed; try the next one
                slot["busy"] = True
                inflight += 1
                return True

        def finish(slot, ok):
            nonlocal inflight
            inflight -= 1
            slot["busy"] = False
            if ok:
                self.latencies.append(time.perf_counter() - slot["t0"])
            else:
                self.failures += 1
                # drop the (possibly poisoned) connection
                self.sel.unregister(slot["sock"])
                slot["sock"].close()
                slot["sock"] = None

        for slot in slots:
            if not feed(slot):
                break
        while inflight > 0:
            for key, _ in self.sel.select(timeout=5.0):
                slot = key.data
                if not slot["busy"]:
                    continue
                try:
                    chunk = slot["sock"].recv(262144)
                except (BlockingIOError, InterruptedError):
                    continue
                except OSError:
                    finish(slot, False)
                    feed(slot)
                    continue
                if not chunk:
                    finish(slot, False)
                    feed(slot)
                    continue
                buf = slot["buf"] = (slot["buf"] + chunk) if slot["buf"] else chunk
                he = buf.find(b"\r\n\r\n")
                if he < 0:
                    continue
                # canonical spelling first (what the turbo engine and the
                # Python http layer both emit); the lower() fallback only
                # pays its allocation for odd peers
                ix = buf.find(b"Content-Length:", 0, he)
                if ix < 0:
                    ix = buf[:he].lower().find(b"content-length:")
                cl = 0
                if ix >= 0:
                    end = buf.find(b"\r\n", ix)
                    if end < 0 or end > he:
                        end = he
                    cl = int(buf[ix + 15:end])
                if len(buf) < he + 4 + cl:
                    continue
                status = int(buf[9:12])
                finish(slot, 200 <= status < 300)
                feed(slot)
        wall = time.perf_counter() - t_start
        # the connections go when the run ends (the JAX package's pump
        # leaves them open, and a server counts them against its watermark)
        for slot in slots:
            if slot["sock"] is not None:
                self.sel.unregister(slot["sock"])
                slot["sock"].close()
                slot["sock"] = None
        return wall


def run_benchmark(master: str, n: int, c: int, size: int,
                  collection: str = "benchmark",
                  assign_batch: int = 100,
                  delete_percent: int = 0) -> dict:
    """Write-then-read load run; returns the raw stats for both phases,
    and the (fid, server) pairs written, the deleted fids and the payload.
    Shared by ``benchmark`` (below) and chip_smoke.py's phase 10.
    delete_percent mirrors the reference's -deletePercent: that fraction of
    written files is deleted (timed) before the read phase, and the reads
    then expect 404s for the deleted fids."""
    import random as _random
    import secrets

    from . import operation

    payload = secrets.token_bytes(size)
    batch = max(1, assign_batch)
    fids: list[tuple[str, str]] = []  # (fid, volume server addr)

    def write_jobs():
        remaining = n
        while remaining > 0:
            a = operation.assign(master, count=min(batch, remaining),
                                 collection=collection)
            got = max(1, a.count)
            for i in range(min(got, remaining)):
                fid = a.fid if i == 0 else f"{a.fid}_{i}"
                fids.append((fid, a.url))
                req = (f"POST /{fid} HTTP/1.1\r\nHost: {a.url}\r\n"
                       f"Content-Length: {len(payload)}\r\n\r\n").encode() + payload
                yield a.url, req
            remaining -= min(got, remaining)

    wpump = _BenchPump(c)
    wwall = wpump.run(write_jobs())

    out = {
        "write": {"wall": wwall, "latencies": wpump.latencies,
                  "failures": wpump.failures},
    }

    rng = _random.Random(42)
    deleted: set[str] = set()
    if delete_percent > 0:
        victims = [f for f in fids if rng.randrange(100) < delete_percent]
        deleted = {f for f, _ in victims}

        def delete_jobs():
            for fid, url in victims:
                req = f"DELETE /{fid} HTTP/1.1\r\nHost: {url}\r\n\r\n".encode()
                yield url, req

        dpump = _BenchPump(c)
        dwall = dpump.run(delete_jobs())
        out["delete"] = {"wall": dwall, "latencies": dpump.latencies,
                         "failures": dpump.failures}

    lookup_cache: dict[int, str] = {}

    def read_jobs():
        live = [(f, u) for f, u in fids if f not in deleted]
        rng.shuffle(live)
        for fid, url in live:
            vid = int(fid.split(",")[0])
            addr = lookup_cache.get(vid)
            if addr is None:
                locs = operation.lookup(master, vid)
                addr = locs[0]["url"] if locs else url
                lookup_cache[vid] = addr
            req = f"GET /{fid} HTTP/1.1\r\nHost: {addr}\r\n\r\n".encode()
            yield addr, req

    rpump = _BenchPump(c)
    rwall = rpump.run(read_jobs())
    out["read"] = {"wall": rwall, "latencies": rpump.latencies,
                   "failures": rpump.failures}
    # what was written, so a caller can read bodies back
    out.update(fids=fids, deleted=deleted, payload=payload)
    return out


def cmd_benchmark(args):
    """The reference's benchmark (command/benchmark.go; its defaults: 1 KB
    files, c=16, n=1048576; -n defaults to 10000 here, as in the JAX
    package's CLI: pass -n 1048576 to match).

    File ids come from count-batched assigns (`/dir/assign?count=N` + the
    `fid_<delta>` sub-fid form, both first-class in the reference:
    master_server_handlers.go:96, needle.go:120-142); -assign.batch 1
    restores one-assign-per-file."""
    batch = max(1, args.assign_batch)
    print(f"writing {args.n} files of {args.size}B with concurrency {args.c} "
          f"(assign batch {batch}) ...")
    stats = run_benchmark(args.master, args.n, args.c, args.size,
                          args.collection, batch,
                          delete_percent=args.delete_percent)
    _report("write", args, stats["write"]["latencies"], stats["write"]["wall"],
            stats["write"]["failures"])
    if "delete" in stats:
        _report("delete", args, stats["delete"]["latencies"],
                stats["delete"]["wall"], stats["delete"]["failures"])
    print("reading surviving files ...")
    _report("read", args, stats["read"]["latencies"], stats["read"]["wall"],
            stats["read"]["failures"])


def _report(op, args, latencies, wall, failures=0):
    import numpy as np

    lat = np.array(sorted(latencies))
    total = len(lat)
    print(f"\n--- {op} ---")
    if total == 0:
        print(f"failed: {failures} / {failures} (no successful requests)")
        return
    print(f"requests/sec: {total / wall:,.2f}")
    print(f"transfer/sec: {total * args.size / wall / 1e6:,.2f} MB/s")
    for p in (50, 90, 99):
        print(f"p{p} latency: {lat[int(total * p / 100) - 1] * 1000:.2f} ms")
    print(f"max latency: {lat[-1] * 1000:.2f} ms")
    print(f"failed: {failures} / {total + failures}")


def cmd_volume(args) -> None:
    from .server.volume_server import VolumeServer

    vs = VolumeServer(
        args.dir.split(","),
        host=args.ip,
        port=args.port,
        master_url=args.mserver,
        data_center=args.data_center,
        rack=args.rack,
        max_volume_count=args.max,
        pulse_seconds=args.pulse,
        ec_backend=args.ec_backend,
        needle_map_kind=args.index,
    )
    vs.start()
    print(f"volume server on {vs.host}:{vs.port} -> master {args.mserver} "
          f"(ec backend {vs.store.ec_backend})", flush=True)
    _serve_until_signalled(vs)


def main(argv=None) -> None:
    from .util import glog

    p = argparse.ArgumentParser(prog="seaweedfs_tpu_torch")
    p.add_argument("-v", type=int, default=0, metavar="LEVEL",
                   help="log verbosity for V-gated messages")
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("master", help="run the master")
    m.add_argument("-ip", default="127.0.0.1")
    m.add_argument("-port", type=int, default=9333)
    m.add_argument("-volumeSizeLimitMB", dest="volume_size_limit_mb", type=int,
                   default=30 * 1024)
    m.add_argument("-defaultReplication", dest="default_replication", default="000")
    m.add_argument("-mdir", default="",
                   help="dir for durable election/sequence state (weed master -mdir)")
    m.add_argument("-peers", default="",
                   help="comma-separated master peers for HA (weed master -peers)")
    m.set_defaults(fn=cmd_master)

    v = sub.add_parser("volume", help="run a volume server")
    v.add_argument("-ip", default="127.0.0.1")
    v.add_argument("-port", type=int, default=8080)
    v.add_argument("-dir", default="./data")
    v.add_argument("-mserver", default="127.0.0.1:9333")
    v.add_argument("-dataCenter", dest="data_center", default="DefaultDataCenter")
    v.add_argument("-rack", default="DefaultRack")
    v.add_argument("-max", type=int, default=7)
    v.add_argument("-pulseSeconds", dest="pulse", type=_positive_pulse, default=5.0)
    v.add_argument("-index", default="dense",
                   choices=["memory", "dense", "sqlite", "sorted"],
                   help="needle map kind (sqlite and sorted are not ported yet)")
    v.add_argument("-ec.backend", dest="ec_backend", default="cuda",
                   choices=["cuda", "cpu"],
                   help="cuda: the hand-written GPU kernel; cpu: its plain version")
    v.set_defaults(fn=cmd_volume)

    sh = sub.add_parser("shell", help="run the admin shell")
    sh.add_argument("-master", default="127.0.0.1:9333")
    sh.add_argument("-c", dest="command", default="",
                    help="run these ';'-separated commands and exit")
    sh.set_defaults(fn=cmd_shell)

    bk = sub.add_parser("backup", help="incremental local volume backup")
    bk.add_argument("-master", default="127.0.0.1:9333")
    bk.add_argument("-volume", type=int, required=True)
    bk.add_argument("-dir", default=".")
    bk.add_argument("-collection", default="")
    bk.set_defaults(fn=cmd_backup)

    cp = sub.add_parser("compact", help="offline-compact a volume")
    cp.add_argument("-dir", default=".")
    cp.add_argument("-collection", default="")
    cp.add_argument("-volumeId", dest="volume_id", type=int, required=True)
    cp.set_defaults(fn=cmd_compact)

    vt = sub.add_parser("volume.tail", help="follow a volume's appended needles")
    vt.add_argument("-master", default="127.0.0.1:9333")
    vt.add_argument("-volumeId", dest="volume_id", type=int, required=True)
    vt.add_argument("-rewind", type=float, default=-1,
                    help="-1: from the first entry; 0: from now; N: N seconds back")
    vt.add_argument("-timeoutSeconds", dest="timeout_seconds", type=float, default=0,
                    help="stop after this long without news (0: follow for ever)")
    vt.add_argument("-showTextFile", dest="show_text", action="store_true",
                    help="print the bodies of text needles")
    vt.add_argument("-pollInterval", dest="poll_interval", type=float, default=1.0)
    vt.set_defaults(fn=cmd_volume_tail)

    b = sub.add_parser("benchmark", help="write/read benchmark")
    b.add_argument("-master", default="127.0.0.1:9333")
    b.add_argument("-c", type=int, default=16)
    b.add_argument("-n", type=int, default=10000)
    b.add_argument("-size", type=int, default=1024)
    b.add_argument("-collection", default="benchmark")
    b.add_argument("-assign.batch", dest="assign_batch", type=int, default=100,
                   help="fids reserved per /dir/assign call (1 = per-file)")
    b.add_argument("-deletePercent", dest="delete_percent", type=int, default=0,
                   help="percent of written files to delete (timed) before the read phase")
    b.set_defaults(fn=cmd_benchmark)

    args = p.parse_args(argv)
    glog.set_verbosity(args.v)
    args.fn(args)


if __name__ == "__main__":
    main()
