"""Command line: ``python -m seaweedfs_tpu_torch [global flags]
master|volume|server|filer|s3|webdav|ftp|msgBroker|mount|filer.copy|filer.sync|
filer.replicate|watch|shell|upload|download|delete|backup|compact|volume.tail|
benchmark|ec.encode|scaffold|fix|export|dump.dat|dump.idx|diff.servers|
change.superblock|version ...``: the JAX package's 30 subcommands, with its
flags.

- The global flags come before the subcommand: glog's ``-v -vmodule
  -logtostderr -logdir -stderrthreshold`` (``util/glog.py``), and
  ``-cpuprofile F`` / ``-memprofile F`` (``util/profiling.py``: cProfile
  stats and tracemalloc's top lines, written at exit and on SIGTERM).
- ``master`` runs a master with the flags of ``weed master``: ``-ip -port
  -volumeSizeLimitMB -defaultReplication -peers -mdir``. ``-peers A,B,C``
  (this master's own address among them) elects one leader of the set;
  ``-mdir D`` keeps the vote, the fid-lease journal and the autopilot's plan
  journal there across restarts. ``SWEED_LIFECYCLE=1`` runs the autopilot on
  the leader (``cluster/lifecycle.py`` lists its ``SWEED_LIFECYCLE_*`` and
  ``SWEED_TIER_*`` knobs).
- ``volume`` runs a volume server with the flags of ``weed volume`` (and of
  the JAX package's CLI): ``-ip -port -dir -mserver -dataCenter -rack -max
  -pulseSeconds -index`` (``memory``, ``dense``, ``sqlite``, ``sorted`` or
  ``mmap``). ``-ec.backend`` is ``cuda`` (the default: the hand-written
  kernel, and EC requests fail without a card), ``mesh`` (the kernel on
  every local card, ``ec/sharded.py``) or ``cpu`` (the kernel's plain
  PyTorch version). ``SWEED_MESH=1`` makes the server a mesh member
  (``server/volume_server.py``). ``master`` and ``volume`` take
  ``-metrics.address host:port`` (a Prometheus push gateway, every
  ``-metrics.intervalSeconds``).
- ``server`` runs a master and a volume server in one process (`weed
  server`): ``-ip -master.port -port -dir -max -ec.backend``, and with
  ``-filer`` a filer (``-filer.port -filer.db``, ``filer.toml`` and
  ``notification.toml`` as for ``filer``), ``-s3`` (``-s3.port
  -s3.config``) and ``-webdav`` (``-webdav.port``) over it, each implying
  ``-filer``. ``-ec.backend`` is ``cuda`` by default, as for ``volume``.
- ``filer`` runs a filer with the flags of ``weed filer``: ``-ip -port
  -master -chunkSizeMB -db -collection -replication -encryptVolumeData
  -peers -metaLogDir``. Its store is ``-db`` (a sqlite file, or
  ``:memory:``); with ``-db`` unset, the first store ``filer.toml`` enables:
  ``[redis]``, ``[sql]`` (any DB-API driver by module name), ``[cassandra]``,
  ``[mongodb]``, ``[etcd]``, ``[elastic7]`` (these four need their client
  SDKs and stop the command naming the one missing) or ``[sqlite]``, else
  ``./filer.db``. ``notification.toml``'s first enabled queue (log, file,
  webhook, aws_sqs, kafka, google_pub_sub) gets every meta event.
  Filer-side queries run on the card; ``SWEED_QUERY_BACKEND=cpu`` runs them
  on the CPU. A sharded fleet of filers is the ``FilerServer(ring_peers=)``
  argument, as in the JAX package: no flag starts one.
- ``s3`` runs the S3 gateway over a filer with the flags of ``weed s3``:
  ``-ip -port -filer -config`` (the identities' ``s3.json``; none: every
  request is allowed) and ``-cert.file -key.file -caCert.file`` (https,
  and with a CA mutual TLS; ``security.toml``'s ``[tls.s3]`` and
  ``tls.ca`` are the fallback). ``-filer a,b,c`` fronts a filer fleet
  through ``filer/ring.RingFilerClient``.
- ``webdav -filer F [-ip -port 7333 -root /]`` runs the WebDAV gateway
  (class 2: locks, dead properties) over a filer, with ``s3``'s TLS flags
  (``security.toml``'s ``[tls.webdav]`` the fallback).
- ``ftp -filer F [-ip -port 8021 -root / -users U.json]`` runs the FTP
  gateway (passive mode; ``-users`` a JSON ``{"user": "password"}``, none:
  anonymous).
- ``msgBroker -filer F [-ip -port 17777]`` runs the pub/sub broker, its
  segments kept under the filer's ``/topics``.
- ``mount -filer F -dir D [-filer.path /] [-collection] [-mode
  auto|fuse|sync] [-scanSeconds 1]`` mounts a filer tree: through FUSE
  (libfuse 2.x and ``/dev/fuse``), or with ``-mode sync`` (and ``auto``
  where FUSE is missing, said on stderr) as a two-way sync of a local
  directory. ``-mode fuse`` without FUSE exits 1.
- ``filer.copy -filer F [-filer.path /] DIR`` uploads a local tree.
- ``filer.sync -a A -b B [-a.path -b.path -isActivePassive]`` keeps two
  filer clusters in sync (``replication/filer_sync.py``), both ways unless
  ``-isActivePassive``.
- ``filer.replicate -filer F [-source] [-sink.dir | -sink.s3]`` mirrors a
  filer's meta events into a sink (``replication.toml``'s, else the flags).
- ``watch -filer F [-v]`` prints a filer's meta events as they come.
- ``upload -master [-maxMB] FILE...``, ``download -master [-o] FID`` and
  ``delete -master FID...`` are the object-store client of ``operation.py``.
- ``shell`` runs the admin shell against ``-master`` (and ``-filer``, for
  ``fs.*``, ``bucket.*``, ``volume.fsck``, ``query`` and ``trace``);
  ``-c "cmd; cmd"`` runs the commands and exits 1 if one failed.
- ``ec.encode -master -volume N`` seals a volume on its holder.
- ``backup -master -volume -dir [-collection]`` makes or brings up to date
  a local copy of a volume (`weed backup`): one incremental pass.
- ``compact -dir -volumeId [-collection]`` compacts a volume offline
  (`weed compact`).
- The offline tools work on a volume's files (``-dir -collection
  -volumeId``), its server stopped: ``fix`` rebuilds the .idx from the
  .dat, ``export -o T.tar [-newer ISO]`` writes the live needles to a tar,
  ``dump.dat`` and ``dump.idx [-ext .ecx] [-offsetSize 4|5]`` print every
  record, ``change.superblock [-replication xyz] [-ttl T]`` prints or
  rewrites the superblock. ``diff.servers -volumeServers A,B -volumeId N``
  compares one volume's needles across live servers (exit 1 on a
  difference).
- ``scaffold -config security|master|filer|replication|backend|
  notification|s3`` prints a configuration template; ``version`` the
  package's version.
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
import gzip
import signal
import threading
import time


def _positive_pulse(s: str) -> float:
    val = float(s)
    if val < 0.1:
        raise argparse.ArgumentTypeError(
            "pulseSeconds must be >= 0.1 (0 would busy-spin the beat loop)")
    return val


def _serve_until_signalled(*servers) -> None:
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    try:
        stop.wait()
    finally:
        for server in servers:
            server.stop()


def _maybe_start_pusher(args, job: str, instance: str):
    """``-metrics.address`` -> the push-gateway loop (stats/metrics.go:69);
    ``/metrics`` serves for pulls either way."""
    if not args.metrics_address:
        return None
    from .stats.metrics import MetricsPusher, default_registry

    return MetricsPusher(default_registry, args.metrics_address, job, instance,
                         interval_seconds=args.metrics_interval).start()


def _security_conf() -> dict:
    """The JWT keys of ``security.toml`` (the scaffold's ``[jwt.signing]``)."""
    from .util.config import load_configuration

    sec = load_configuration("security")
    return {"jwt_signing_key": sec.get("jwt.signing.key", "") or "",
            "jwt_read_key": sec.get("jwt.signing.read.key", "") or ""}


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
    pusher = _maybe_start_pusher(args, "master", ms.url)
    print(f"master listening on {ms.url}", flush=True)
    _serve_until_signalled(*filter(None, (pusher, ms)))


def cmd_shell(args) -> None:
    from .shell.shell import run_shell

    run_shell(args.master, args.filer, command=args.command)


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


def _filer_store_from_conf(db_path: str):
    """filer.toml store selection (first enabled store wins); an explicit
    ``-db`` beats the config file, and an unset ``-db`` with no config lands
    on a persistent ``./filer.db`` (``:memory:`` when the cwd is read-only).
    Returns ``(db_path, store)``: ``store`` is None for the sqlite path."""
    import os
    import sys

    from .util.config import load_configuration

    if db_path:
        return db_path, None
    conf = load_configuration("filer")
    store = None
    if conf.get_bool("redis.enabled"):
        from .filer.redis_store import RedisStore

        store = RedisStore(address=conf.get("redis.address", "127.0.0.1:6379"),
                           password=conf.get("redis.password", ""),
                           database=int(conf.get("redis.database", 0) or 0))
    elif conf.get_bool("sql.enabled"):
        from .filer.abstract_sql import GenericSqlStore

        kwargs = {k: v for k, v in conf.sub("sql").items()
                  if k not in ("enabled", "driver", "dialect")}
        store = GenericSqlStore(conf.get("sql.driver"), dialect=conf.get("sql.dialect", ""),
                                **kwargs)
    elif conf.get_bool("cassandra.enabled"):
        from .filer.sdk_stores import CassandraStore

        store = CassandraStore(
            hosts=[h.strip() for h in str(conf.get("cassandra.hosts", "127.0.0.1")).split(",")],
            keyspace=conf.get("cassandra.keyspace", "seaweedfs"),
            username=conf.get("cassandra.username", ""),
            password=conf.get("cassandra.password", ""),
            port=int(conf.get("cassandra.port", 9042)))
    elif conf.get_bool("mongodb.enabled"):
        from .filer.sdk_stores import MongoStore

        store = MongoStore(uri=conf.get("mongodb.uri", "mongodb://127.0.0.1:27017"),
                           database=conf.get("mongodb.database", "seaweedfs"))
    elif conf.get_bool("etcd.enabled"):
        from .filer.sdk_stores import EtcdStore

        store = EtcdStore(endpoint=conf.get("etcd.servers", "127.0.0.1:2379"),
                          prefix=conf.get("etcd.prefix", "seaweedfs."))
    elif conf.get_bool("elastic7.enabled"):
        from .filer.sdk_stores import ElasticStore

        store = ElasticStore(
            servers=[x.strip() for x in str(
                conf.get("elastic7.servers", "http://127.0.0.1:9200")).split(",")],
            index=conf.get("elastic7.index", "seaweedfs"))
    elif conf.get_bool("sqlite.enabled"):
        return conf.get("sqlite.dbFile", "./filer.db"), None
    if store is not None:
        return "", store
    if not os.access(os.path.dirname(os.path.abspath("./filer.db")), os.W_OK):
        print("WARNING: cwd not writable; filer metadata is IN-MEMORY and will "
              "not survive a restart (pass -db or mount a writable dir)",
              file=sys.stderr)
        return ":memory:", None
    return "./filer.db", None


def _filer_notifications(fs) -> None:
    """notification.toml → publish meta events to the configured queue."""
    from .replication import NotificationBus, make_queue
    from .util.config import load_configuration

    q = make_queue(load_configuration("notification"))
    if q is not None:
        NotificationBus(fs.filer).add_queue(q)
        print(f"notifications -> {type(q).__name__}", flush=True)


def cmd_filer(args) -> None:
    from .server.filer_server import FilerServer

    db_path, store = _filer_store_from_conf(args.db)
    fs = FilerServer(
        host=args.ip,
        port=args.port,
        master_url=args.master,
        chunk_size=args.chunk_size_mb * 1024 * 1024,
        db_path=db_path,
        collection=args.collection,
        replication=args.replication,
        cipher=args.encrypt_volume_data,
        peers=[p for p in args.peers.split(",") if p],
        meta_log_dir=args.meta_log_dir,
        store=store,
    ).start()
    _filer_notifications(fs)
    where = type(store).__name__ if store is not None else db_path
    print(f"filer on {fs.url} -> master {args.master} (store {where})", flush=True)
    _serve_until_signalled(fs)


def cmd_filer_sync(args) -> None:
    from .replication import FilerSync

    syncers = [FilerSync(args.a, args.b, source_path=args.a_path,
                         target_path=args.b_path).start()]
    mode = "active-passive"
    if not args.is_active_passive:
        syncers.append(FilerSync(args.b, args.a, source_path=args.b_path,
                                 target_path=args.a_path).start())
        mode = "active-active"
    print(f"filer.sync {mode}: {args.a}{args.a_path} <-> {args.b}{args.b_path}", flush=True)
    _serve_until_signalled(*syncers)


def cmd_filer_replicate(args) -> None:
    from .filer.client import FilerClient
    from .replication import LocalFsSink, Replicator, S3Sink, make_sink
    from .util import glog
    from .util.config import load_configuration

    src = FilerClient(args.filer)
    if args.sink_s3:
        endpoint, bucket = args.sink_s3.rsplit("/", 1)
        sink = S3Sink(endpoint, bucket, args.s3_access_key, args.s3_secret_key)
    else:
        # replication.toml picks the sink (gcs/backblaze/azure too); the
        # -sink.dir local directory otherwise
        try:
            sink = make_sink(load_configuration("replication"))
        except ValueError:
            sink = LocalFsSink(args.sink_dir)
    repl = Replicator(sink, read_content=lambda p: src.get_object(p)[1],
                      source_path=args.source)
    offset = 0
    print(f"replicating {args.filer}{args.source} -> {type(sink).__name__}; "
          "ctrl-c to stop", flush=True)
    while True:
        resp = src.meta_events(since_ns=offset)
        for ev in resp.get("events", []):
            # a flaky sink must not kill the daemon: retry with backoff,
            # then skip the event (repl_util.go RetriedWriteFile)
            for attempt in range(3):
                try:
                    repl.replicate(ev)
                    break
                except Exception as e:  # noqa: BLE001 — the sink's failure is logged, the event skipped
                    glog.warning("replicate %s attempt %d failed: %s",
                                 (ev.get("new_entry") or ev.get("old_entry") or {})
                                 .get("full_path", "?"), attempt + 1, e)
                    if attempt < 2:  # no pointless sleep after the last try
                        time.sleep(2 ** attempt)
            offset = ev["ts_ns"]
        if not resp.get("events"):
            time.sleep(1.0)


def cmd_watch(args) -> None:
    """Tail a filer's meta event stream (weed watch)."""
    import json

    from .filer.client import FilerClient

    client = FilerClient(args.filer)
    offset = 0
    while True:
        resp = client.meta_events(since_ns=offset)
        for ev in resp.get("events", []):
            offset = ev["ts_ns"]
            kind = ("create" if not ev["old_entry"]
                    else "delete" if not ev["new_entry"] else "update")
            path = (ev["new_entry"] or ev["old_entry"]).get("full_path")
            print(f"{ev['ts_ns']} {kind:7s} {path}", flush=True)
            if args.verbose:
                print(json.dumps(ev, indent=2), flush=True)
        if not resp.get("events"):
            time.sleep(0.5)


def cmd_s3(args) -> None:
    import json

    from .s3api import IAM, S3ApiServer

    iam = IAM()
    if args.config:
        with open(args.config) as f:
            iam = IAM.from_config(json.load(f))
    cert, key, ca = _tls_triplet(args, "s3")
    api = S3ApiServer(host=args.ip, port=args.port, filer_url=args.filer, iam=iam,
                      tls_cert=cert, tls_key=key, tls_ca=ca).start()
    scheme = "https" if cert else "http"
    print(f"s3 gateway on {scheme}://{api.url} -> filer {args.filer}", flush=True)
    _serve_until_signalled(api)


def cmd_webdav(args) -> None:
    from .server.webdav_server import WebDavServer

    cert, key, ca = _tls_triplet(args, "webdav")
    srv = WebDavServer(host=args.ip, port=args.port, filer_url=args.filer, root=args.root,
                       tls_cert=cert, tls_key=key, tls_ca=ca).start()
    scheme = "https" if cert else "http"
    print(f"webdav on {scheme}://{srv.url} -> filer {args.filer}", flush=True)
    _serve_until_signalled(srv)


def cmd_ftp(args) -> None:
    import json

    from .server.ftp_server import FtpServer

    users = {}
    if args.users:
        with open(args.users) as f:
            users = json.load(f)
    srv = FtpServer(host=args.ip, port=args.port, filer_url=args.filer, root=args.root,
                    users=users).start()
    print(f"ftp on {srv.url} -> filer {args.filer}", flush=True)
    _serve_until_signalled(srv)


def cmd_msg_broker(args) -> None:
    from .messaging import Broker

    b = Broker(host=args.ip, port=args.port, filer_url=args.filer).start()
    print(f"message broker on {b.url} -> filer {args.filer}", flush=True)
    _serve_until_signalled(b)


def cmd_mount(args) -> None:
    """weed mount: a kernel-visible FUSE filesystem over the filer when
    libfuse and /dev/fuse are present (filesys/wfs.go), else (``-mode
    auto``) the FUSE-less two-way sync of a local directory."""
    import sys

    if args.mode != "sync":
        from .mount.fuse_mount import FuseMount, fuse_available

        if fuse_available():
            from .mount.wfs import WFS

            wfs = WFS(args.filer, collection=args.collection)
            fm = FuseMount(wfs, args.dir, root=args.filer_path).mount()
            print(f"FUSE-mounted {args.filer}{args.filer_path} at {args.dir}", flush=True)
            try:
                _serve_until_signalled()
            finally:
                fm.unmount()
                wfs.close()
            return
        if args.mode == "fuse":
            print("fuse unavailable (no libfuse or /dev/fuse)", file=sys.stderr)
            sys.exit(1)
        print("fuse unavailable; falling back to sync mode", file=sys.stderr)
    from .mount.sync import MountSync

    ms = MountSync(args.filer, args.filer_path, args.dir,
                   scan_seconds=args.scan_seconds).start()
    print(f"mounted {args.filer}{args.filer_path} <-> {args.dir}", flush=True)
    _serve_until_signalled(ms)


def cmd_filer_copy(args) -> None:
    """Upload a local tree to the filer (weed filer.copy)."""
    from .mount.sync import copy_to_filer

    n = copy_to_filer(args.dir, args.filer, args.filer_path)
    print(f"copied {n} files from {args.dir} to {args.filer}{args.filer_path}")


def _add_tls_flags(parser) -> None:
    parser.add_argument("-cert.file", dest="cert", default="",
                        help="TLS certificate (enables https)")
    parser.add_argument("-key.file", dest="key", default="",
                        help="private key; empty = combined PEM in cert.file")
    parser.add_argument("-caCert.file", dest="ca_cert", default="",
                        help="require CA-signed client certs (mTLS)")


def _tls_triplet(args, component: str) -> tuple[str, str, str]:
    """The flags win; ``security.toml``'s ``[tls.<component>]`` and
    ``tls.ca`` are the fallback (as `security/tls.go` loads them)."""
    from .util.config import load_configuration

    sec = load_configuration("security")
    return (args.cert or sec.get(f"tls.{component}.cert", "") or "",
            args.key or sec.get(f"tls.{component}.key", "") or "",
            args.ca_cert or sec.get("tls.ca", "") or "")


def cmd_upload(args) -> None:
    import os

    from . import operation

    for path in args.files:
        with open(path, "rb") as f:
            data = f.read()
        fid = operation.submit(args.master, data, name=os.path.basename(path),
                               replication=args.replication,
                               collection=args.collection, ttl=args.ttl,
                               max_mb=args.max_mb)
        print(f"{path}\t{fid}")


def cmd_download(args) -> None:
    import sys

    from . import operation

    data = operation.download(args.master, args.fid)
    if args.output == "-":
        sys.stdout.buffer.write(data)
    else:
        with open(args.output, "wb") as f:
            f.write(data)
        print(f"{args.fid} -> {args.output} ({len(data)} bytes)")


def cmd_delete(args) -> None:
    from . import operation

    n = operation.delete_files(args.master, args.fids)
    print(f"deleted {n}/{len(args.fids)}")


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
    pusher = _maybe_start_pusher(args, "volumeServer", f"{vs.host}:{vs.port}")
    print(f"volume server on {vs.host}:{vs.port} -> master {args.mserver} "
          f"(ec backend {vs.store.ec_backend})", flush=True)
    _serve_until_signalled(*filter(None, (pusher, vs)))


def cmd_server(args) -> None:
    """Master and volume server in one process (`weed server`,
    command/server.go:119), with ``-filer``, and ``-s3`` / ``-webdav`` over
    that filer (each implies it). The filer's store and queue come from
    ``filer.toml`` and ``notification.toml`` as for the ``filer`` command."""
    from .server.master_server import MasterServer
    from .server.volume_server import VolumeServer

    servers = []
    try:
        ms = MasterServer(host=args.ip, port=args.master_port).start()
        servers.append(ms)
        vs = VolumeServer(args.dir.split(","), host=args.ip, port=args.port,
                          master_url=ms.url, max_volume_count=args.max,
                          ec_backend=args.ec_backend).start()
        servers.append(vs)
        parts = [f"master {ms.url}", f"volume {vs.host}:{vs.port} "
                 f"(ec backend {vs.store.ec_backend})"]
        if args.filer or args.s3 or args.webdav:
            from .server.filer_server import FilerServer

            db_path, store = _filer_store_from_conf(args.filer_db)
            sec = _security_conf()
            fs = FilerServer(host=args.ip, port=args.filer_port, master_url=ms.url,
                             db_path=db_path, store=store,
                             jwt_signing_key=sec["jwt_signing_key"],
                             jwt_read_key=sec["jwt_read_key"]).start()
            servers.append(fs)
            _filer_notifications(fs)
            parts.append(f"filer {fs.url}")
            if args.s3:
                import json

                from .s3api import IAM, S3ApiServer

                iam = IAM()
                if args.s3_config:
                    with open(args.s3_config) as f:
                        iam = IAM.from_config(json.load(f))
                s3 = S3ApiServer(host=args.ip, port=args.s3_port, filer_url=fs.url,
                                 iam=iam).start()
                servers.append(s3)
                parts.append(f"s3 {s3.url}")
            if args.webdav:
                from .server.webdav_server import WebDavServer

                wd = WebDavServer(host=args.ip, port=args.webdav_port,
                                  filer_url=fs.url).start()
                servers.append(wd)
                parts.append(f"webdav {wd.url}")
    except BaseException:
        for server in reversed(servers):
            server.stop()
        raise
    print("server: " + ", ".join(parts), flush=True)
    _serve_until_signalled(*reversed(servers))  # gateways stop first


def cmd_ec_encode(args) -> None:
    """Seal one volume where it lives (``/admin/ec/generate`` on its first
    holder, which runs the GF(2^8) product on its backend)."""
    import sys

    from . import operation
    from .server.http_util import http_json

    locs = operation.lookup(args.master, args.volume)
    if not locs:
        print(f"volume {args.volume} not found", file=sys.stderr)
        sys.exit(1)
    r = http_json("POST", f"http://{locs[0]['url']}/admin/ec/generate?volume={args.volume}")
    print(r)


def cmd_scaffold(args) -> None:
    """Print a configuration template (`weed scaffold` -> <name>.toml)."""
    from .util.config import SCAFFOLDS

    templates = dict(SCAFFOLDS)
    templates["s3"] = (
        "# s3.json — identities for the S3 gateway\n"
        '{\n  "identities": [\n    {\n      "name": "admin",\n'
        '      "credentials": [{"accessKey": "AKEXAMPLE", '
        '"secretKey": "SKEXAMPLE"}],\n      "actions": ["Admin"]\n'
        "    }\n  ]\n}\n"
    )
    print(templates.get(args.config, f"unknown config {args.config!r}; "
                                     f"choose from {sorted(templates)}"))


def cmd_fix(args) -> None:
    """Rebuild a volume's .idx from its .dat (`weed fix`, command/fix.go)."""
    import os

    from .storage.volume import Volume, volume_file_name

    base = volume_file_name(args.dir, args.collection, args.volume_id)
    idx = base + ".idx"
    if not (os.path.exists(base + ".dat") or os.path.exists(base + ".tier")):
        # checked before the index is touched: a mistyped -dir must not
        # destroy a stray .idx it cannot rebuild
        raise SystemExit(f"no volume data at {base}.dat")
    if os.path.exists(idx):
        os.unlink(idx)  # fix.go wants the index gone; the load redoes it
    v = Volume(args.dir, collection=args.collection, vid=args.volume_id,
               create_if_missing=False)
    try:
        print(f"fixed {idx}: {v.file_count()} entries ({v.deleted_count()} tombstones)")
    finally:
        v.close()


def cmd_export(args) -> None:
    """The live needles of a volume as a tar (`weed export`,
    command/export.go): named by their stored name, else ``<vid>_<key>``,
    ungzipped; ``-newer`` keeps those modified after an ISO time."""
    import tarfile
    from datetime import datetime
    from io import BytesIO

    from .storage.types import size_is_valid
    from .storage.volume import Volume

    newer_than = datetime.fromisoformat(args.newer).timestamp() if args.newer else 0.0
    v = Volume(args.dir, collection=args.collection, vid=args.volume_id,
               create_if_missing=False)
    count = skipped = 0
    try:
        with tarfile.open(args.output, "w") as tf:
            for n, offset, _ in v.scan_needles():
                nv = v.nm.get(n.id)
                if (nv is None or not size_is_valid(nv.size)  # deleted
                        or nv.offset != offset  # overwritten later
                        or not n.data):
                    continue
                # a needle without a time fails the cutoff too, as export.go's
                # unconditional compare
                if newer_than and n.last_modified < newer_than:
                    skipped += 1
                    continue
                name = n.name.decode("utf-8", "replace") if n.name else f"{v.id:d}_{n.id:x}"
                data = bytes(n.data)
                if n.is_compressed:
                    data = gzip.decompress(data)
                info = tarfile.TarInfo(name=name)
                info.size = len(data)
                info.mtime = n.last_modified or int(time.time())
                tf.addfile(info, BytesIO(data))
                count += 1
    finally:
        v.close()
    print(f"exported {count} files to {args.output} ({skipped} skipped)")


def cmd_dump_dat(args) -> None:
    """Every record of a volume's .dat, by walking its bytes (the see_dat
    tool, `unmaintained/see_dat/see_dat.go:1`). Read-only: no needle map is
    built and no .idx is made or touched, so it is safe on a forensic
    copy."""
    import struct
    from datetime import datetime

    from .storage.needle import NEEDLE_HEADER_SIZE, Needle, needle_body_length, \
        parse_needle_header
    from .storage.super_block import SuperBlock
    from .storage.volume import volume_file_name

    base = volume_file_name(args.dir, args.collection, args.volume_id)
    with open(base + ".dat", "rb") as f:
        # the 8-byte header carries extra_size, which can push the first
        # record past a fixed slice
        head = f.read(8)
        extra_size = struct.unpack(">H", head[6:8])[0] if len(head) == 8 else 0
        f.seek(0)
        sb = SuperBlock.from_bytes(f.read(8 + extra_size))
        offset = sb.block_size()
        f.seek(0, 2)
        size = f.tell()
        print(f"# volume {args.volume_id} version {sb.version} "
              f"replication {sb.replica_placement} "
              f"compactRevision {sb.compaction_revision} size {size}")
        count = 0
        while offset + NEEDLE_HEADER_SIZE <= size:
            f.seek(offset)
            hdr = f.read(NEEDLE_HEADER_SIZE)
            if len(hdr) < NEEDLE_HEADER_SIZE:
                break
            cookie, nid, nsize = parse_needle_header(hdr)
            body_len = needle_body_length(max(nsize, 0), sb.version)
            total = NEEDLE_HEADER_SIZE + body_len
            if offset + total > size:
                print(f"# torn record at offset {offset} (truncated write?)")
                break
            n = Needle(cookie=cookie, id=nid, size=nsize)
            ts = ""
            try:
                n.read_body_bytes(f.read(body_len), sb.version)
                if n.append_at_ns:
                    ts = " appendedAt " + datetime.fromtimestamp(
                        n.append_at_ns / 1e9).isoformat()
            except Exception as e:  # noqa: BLE001 — forensics keeps walking
                ts = f" BODY-ERROR {e}"
            # the .dat alone cannot tell an empty put from a deletion
            # marker (both append size-0 records); only the .idx can
            kind = "size 0 (empty-or-tombstone)" if nsize <= 0 else f"size {nsize}"
            print(f"{args.volume_id},{nid:x}{cookie:08x} offset {offset} "
                  f"{kind} data {len(n.data)}B{ts}")
            count += 1
            offset += total
        print(f"# {count} records")


def cmd_dump_idx(args) -> None:
    """Every .idx (or .ecx) entry in file order (the see_idx tool,
    `unmaintained/see_idx/see_idx.go:1`)."""
    from .storage import idx as idx_mod
    from .storage.types import TOMBSTONE_FILE_SIZE
    from .storage.volume import volume_file_name

    path = volume_file_name(args.dir, args.collection, args.volume_id) + args.ext
    count = 0
    with open(path, "rb") as f:
        for key, offset, size in idx_mod.iter_index_file(f, args.offset_size):
            tag = " (tombstone)" if size == TOMBSTONE_FILE_SIZE or offset == 0 else ""
            print(f"key:{key:x} offset:{offset} size:{size}{tag}")
            count += 1
    print(f"# {count} entries")


def cmd_diff_servers(args) -> None:
    """One volume's needles across servers (the diff_volume_servers tool,
    `unmaintained/diff_volume_servers/diff_volume_servers.go:34`): for each
    needle that differs, ``<vid>,<key> <server> missing|deleted|
    notDeleted|wrongSize`` against the other servers' majority; exit 1 if
    any differs."""
    import io

    from .server.http_util import http_bytes
    from .storage import idx as idx_mod
    from .storage.types import TOMBSTONE_FILE_SIZE

    servers = [s for s in args.volume_servers.split(",") if s]
    if len(servers) < 2:
        raise SystemExit("need at least two -volumeServers to diff")
    vid = args.volume_id
    states: dict[str, dict[int, int]] = {}  # server -> {key: size, -1 deleted}
    for addr in servers:
        status, data = http_bytes("GET", f"http://{addr}/admin/file?volume={vid}"
                                         f"&collection={args.collection}&ext=.idx")
        if status != 200:
            raise SystemExit(f"{addr}: fetching volume {vid} idx: HTTP {status}")
        live: dict[int, int] = {}
        for key, offset, size in idx_mod.iter_index_file(io.BytesIO(data), args.offset_size):
            live[key] = -1 if offset == 0 or size == TOMBSTONE_FILE_SIZE else size
        states[addr] = live
    every: set[int] = set()
    for live in states.values():
        every.update(live)
    diffs = 0
    for key in sorted(every):
        vals = {addr: states[addr].get(key) for addr in servers}
        if len(set(vals.values())) <= 1:
            continue  # the same everywhere
        # what is wrong on each server, against the others' majority view
        for addr, val in vals.items():
            others = [ov for a, ov in vals.items() if a != addr]
            ref = max(set(others), key=others.count)
            if val == ref:
                continue
            if val is None:
                msg = "missing"
            elif ref is None:
                # this server has it; those lacking it get their own
                # 'missing' lines (a wrongSize here would be a phantom)
                continue
            elif val == -1:
                msg = "deleted"
            elif ref == -1:
                msg = "notDeleted"
            else:
                msg = "wrongSize"
            print(f"{vid},{key:x} {addr} {msg}")
            diffs += 1
    print(f"# {diffs} differences across {len(servers)} servers")
    if diffs:
        raise SystemExit(1)


def cmd_change_superblock(args) -> None:
    """Rewrite the replication and TTL bytes of a volume's superblock in
    place (the change_superblock tool, `unmaintained/change_superblock/
    change_superblock.go:41`); with neither flag, print them only. The
    server holding the .dat must be stopped first, as in the reference."""
    from .storage.replica_placement import ReplicaPlacement
    from .storage.super_block import SUPER_BLOCK_SIZE, SuperBlock
    from .storage.ttl import read_ttl
    from .storage.volume import volume_file_name

    base = volume_file_name(args.dir, args.collection, args.volume_id)
    with open(base + ".dat", "r+b") as f:
        # extra_size is a u16 and from_bytes slices what the header
        # declares, so reading its maximum is always enough
        sb = SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE + 0xFFFF))
        print(f"Current Volume Replication: {sb.replica_placement}")
        print(f"Current Volume TTL: {sb.ttl}")
        changed = False
        if args.replication:
            sb.replica_placement = ReplicaPlacement.from_string(args.replication)
            print(f"Changing replication to: {sb.replica_placement}")
            changed = True
        if args.ttl:
            sb.ttl = read_ttl(args.ttl)
            print(f"Changing ttl to: {sb.ttl}")
            changed = True
        if changed:
            blob = sb.to_bytes()
            # both live in the fixed 8-byte header; the extra section is
            # untouched, so no record moves
            assert len(blob) == sb.block_size()
            f.seek(0)
            f.write(blob)
            print("Done.")


def cmd_version(args) -> None:
    from . import __version__

    print(f"seaweedfs_tpu_torch {__version__}")


def main(argv=None) -> None:
    from .util import glog

    p = argparse.ArgumentParser(prog="seaweedfs_tpu_torch")
    glog.add_flags(p)  # global flags, before the subcommand (as in weed)
    p.add_argument("-cpuprofile", default="",
                   help="write a CPU profile (cProfile stats) on exit")
    p.add_argument("-memprofile", default="",
                   help="write a memory profile (tracemalloc top) on exit")
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
    _add_metrics_flags(m)
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
                   choices=["memory", "dense", "sqlite", "sorted", "mmap"],
                   help="needle map kind: memory, dense (16 B an entry), sqlite "
                        "(<vol>.ldb), sorted (read-only <vol>.sdx), mmap (<vol>.mdx)")
    v.add_argument("-ec.backend", dest="ec_backend", default="cuda",
                   choices=["cuda", "cpu", "mesh"],
                   help="cuda: the hand-written GPU kernel; cpu: its plain version; "
                        "mesh: the kernel on every local GPU (ec/sharded.py)")
    _add_metrics_flags(v)
    v.set_defaults(fn=cmd_volume)

    s = sub.add_parser("server", help="master + volume (+ filer/s3/webdav) in one process")
    s.add_argument("-ip", default="127.0.0.1")
    s.add_argument("-master.port", dest="master_port", type=int, default=9333)
    s.add_argument("-port", type=int, default=8080)
    s.add_argument("-dir", default="./data")
    s.add_argument("-max", type=int, default=7)
    s.add_argument("-ec.backend", dest="ec_backend", default="cuda",
                   choices=["cuda", "cpu", "mesh"],
                   help="the volume server's codec, as volume's -ec.backend")
    s.add_argument("-filer", action="store_true",
                   help="also run a filer (command/server.go -filer)")
    s.add_argument("-filer.port", dest="filer_port", type=int, default=8888)
    s.add_argument("-filer.db", dest="filer_db", default="",
                   help="sqlite path (default ./filer.db; ':memory:' for ephemeral; "
                        "filer.toml's store when unset, as filer -db)")
    s.add_argument("-s3", action="store_true", help="also run the S3 gateway (implies -filer)")
    s.add_argument("-s3.port", dest="s3_port", type=int, default=8333)
    s.add_argument("-s3.config", dest="s3_config", default="",
                   help="identities json for the embedded S3 gateway")
    s.add_argument("-webdav", action="store_true",
                   help="also run the WebDAV gateway (implies -filer)")
    s.add_argument("-webdav.port", dest="webdav_port", type=int, default=7333)
    s.set_defaults(fn=cmd_server)

    f = sub.add_parser("filer", help="run a filer server")
    f.add_argument("-ip", default="127.0.0.1")
    f.add_argument("-port", type=int, default=8888)
    f.add_argument("-master", default="127.0.0.1:9333")
    f.add_argument("-chunkSizeMB", dest="chunk_size_mb", type=int, default=32)
    f.add_argument("-db", default="",
                   help="sqlite path (default ./filer.db; ':memory:' for "
                        "ephemeral; filer.toml's store when unset)")
    f.add_argument("-collection", default="")
    f.add_argument("-replication", default="")
    f.add_argument("-encryptVolumeData", dest="encrypt_volume_data",
                   action="store_true",
                   help="AES-256-GCM encrypt chunk data (weed filer -encryptVolumeData)")
    f.add_argument("-peers", default="",
                   help="comma-separated peer filer host:port list (weed filer -peers)")
    f.add_argument("-metaLogDir", dest="meta_log_dir", default="",
                   help="directory for persisted meta-log segments (default: beside -db)")
    f.set_defaults(fn=cmd_filer)

    s3 = sub.add_parser("s3", help="run the S3 gateway over a filer")
    s3.add_argument("-ip", default="127.0.0.1")
    s3.add_argument("-port", type=int, default=8333)
    s3.add_argument("-filer", default="127.0.0.1:8888",
                    help="a filer, or a comma list of a filer fleet's members")
    s3.add_argument("-config", default="", help="identities json (s3.json)")
    _add_tls_flags(s3)
    s3.set_defaults(fn=cmd_s3)

    wd = sub.add_parser("webdav", help="run the WebDAV gateway over a filer")
    wd.add_argument("-ip", default="127.0.0.1")
    wd.add_argument("-port", type=int, default=7333)
    wd.add_argument("-filer", default="127.0.0.1:8888")
    wd.add_argument("-root", default="/")
    _add_tls_flags(wd)
    wd.set_defaults(fn=cmd_webdav)

    ftp = sub.add_parser("ftp", help="run the FTP gateway over a filer")
    ftp.add_argument("-ip", default="127.0.0.1")
    ftp.add_argument("-port", type=int, default=8021)
    ftp.add_argument("-filer", default="127.0.0.1:8888")
    ftp.add_argument("-root", default="/")
    ftp.add_argument("-users", default="",
                     help='JSON file {"user": "password"}; empty = anonymous')
    ftp.set_defaults(fn=cmd_ftp)

    mb = sub.add_parser("msgBroker", help="run the pub/sub message broker")
    mb.add_argument("-ip", default="127.0.0.1")
    mb.add_argument("-port", type=int, default=17777)
    mb.add_argument("-filer", default="127.0.0.1:8888")
    mb.set_defaults(fn=cmd_msg_broker)

    mnt = sub.add_parser("mount", help="mount the filer (FUSE, or local-dir sync)")
    mnt.add_argument("-filer", dest="filer", default="127.0.0.1:8888")
    mnt.add_argument("-filer.path", dest="filer_path", default="/")
    mnt.add_argument("-dir", dest="dir", required=True)
    mnt.add_argument("-collection", default="")
    mnt.add_argument("-mode", choices=("auto", "fuse", "sync"), default="auto",
                     help="auto = FUSE when libfuse + /dev/fuse exist")
    mnt.add_argument("-scanSeconds", dest="scan_seconds", type=float, default=1.0)
    mnt.set_defaults(fn=cmd_mount)

    fcp = sub.add_parser("filer.copy", help="upload a local tree to the filer")
    fcp.add_argument("-filer", dest="filer", default="127.0.0.1:8888")
    fcp.add_argument("-filer.path", dest="filer_path", default="/")
    fcp.add_argument("dir")
    fcp.set_defaults(fn=cmd_filer_copy)

    fsync = sub.add_parser("filer.sync", help="sync two filer clusters")
    fsync.add_argument("-a", required=True, help="filer A host:port")
    fsync.add_argument("-b", required=True, help="filer B host:port")
    fsync.add_argument("-a.path", dest="a_path", default="/")
    fsync.add_argument("-b.path", dest="b_path", default="/")
    fsync.add_argument("-isActivePassive", dest="is_active_passive", action="store_true")
    fsync.set_defaults(fn=cmd_filer_sync)

    frep = sub.add_parser("filer.replicate", help="replicate a filer's events to a sink")
    frep.add_argument("-filer", default="127.0.0.1:8888")
    frep.add_argument("-source", default="/")
    frep.add_argument("-sink.dir", dest="sink_dir", default="./replica")
    frep.add_argument("-sink.s3", dest="sink_s3", default="", help="http://endpoint/bucket")
    frep.add_argument("-s3.accessKey", dest="s3_access_key", default="")
    frep.add_argument("-s3.secretKey", dest="s3_secret_key", default="")
    frep.set_defaults(fn=cmd_filer_replicate)

    w = sub.add_parser("watch", help="tail a filer's meta events")
    w.add_argument("-filer", default="127.0.0.1:8888")
    w.add_argument("-v", dest="verbose", action="store_true")
    w.set_defaults(fn=cmd_watch)

    u = sub.add_parser("upload", help="upload files")
    u.add_argument("-master", default="127.0.0.1:9333")
    u.add_argument("-replication", default="")
    u.add_argument("-collection", default="")
    u.add_argument("-ttl", default="")
    u.add_argument("-maxMB", dest="max_mb", type=int, default=32,
                   help="split larger files into chunks + manifest needle")
    u.add_argument("files", nargs="+")
    u.set_defaults(fn=cmd_upload)

    d = sub.add_parser("download", help="download by fid")
    d.add_argument("-master", default="127.0.0.1:9333")
    d.add_argument("-o", dest="output", default="-")
    d.add_argument("fid")
    d.set_defaults(fn=cmd_download)

    de = sub.add_parser("delete", help="delete fids")
    de.add_argument("-master", default="127.0.0.1:9333")
    de.add_argument("fids", nargs="+")
    de.set_defaults(fn=cmd_delete)

    sh = sub.add_parser("shell", help="run the admin shell")
    sh.add_argument("-master", default="127.0.0.1:9333")
    sh.add_argument("-filer", default="",
                    help="filer url for fs.*/bucket.*/fsck/query/trace commands")
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
    _add_volume_file_flags(cp)
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

    e = sub.add_parser("ec.encode", help="erasure-code a volume")
    e.add_argument("-master", default="127.0.0.1:9333")
    e.add_argument("-volume", type=int, required=True)
    e.set_defaults(fn=cmd_ec_encode)

    sc = sub.add_parser("scaffold", help="print config templates")
    sc.add_argument("-config", default="security")
    sc.set_defaults(fn=cmd_scaffold)

    fx = sub.add_parser("fix", help="rebuild a volume's .idx from its .dat")
    _add_volume_file_flags(fx)
    fx.set_defaults(fn=cmd_fix)

    ex = sub.add_parser("export", help="export volume contents to a tar")
    _add_volume_file_flags(ex)
    ex.add_argument("-o", dest="output", required=True, help="output .tar")
    ex.add_argument("-newer", default="", help="only files newer than ISO timestamp")
    ex.set_defaults(fn=cmd_export)

    dd = sub.add_parser("dump.dat", help="print every .dat record (see_dat analog)")
    _add_volume_file_flags(dd)
    dd.set_defaults(fn=cmd_dump_dat)

    di = sub.add_parser("dump.idx", help="print every .idx entry (see_idx analog)")
    _add_volume_file_flags(di)
    di.add_argument("-ext", default=".idx", choices=[".idx", ".ecx"])
    di.add_argument("-offsetSize", dest="offset_size", type=int, default=4, choices=[4, 5])
    di.set_defaults(fn=cmd_dump_idx)

    ds = sub.add_parser("diff.servers",
                        help="diff a volume across servers (diff_volume_servers analog)")
    ds.add_argument("-volumeServers", dest="volume_servers", required=True,
                    help="comma-delimited host:port list")
    ds.add_argument("-volumeId", dest="volume_id", type=int, required=True)
    ds.add_argument("-collection", default="")
    ds.add_argument("-offsetSize", dest="offset_size", type=int, default=4, choices=[4, 5])
    ds.set_defaults(fn=cmd_diff_servers)

    cs = sub.add_parser("change.superblock",
                        help="edit replication/TTL bits of a sealed .dat in place "
                             "(change_superblock analog)")
    _add_volume_file_flags(cs)
    cs.add_argument("-replication", default="",
                    help="target xyz replication; empty = print only")
    cs.add_argument("-ttl", default="", help="target TTL (e.g. 3d); empty = print only")
    cs.set_defaults(fn=cmd_change_superblock)

    ver = sub.add_parser("version")
    ver.set_defaults(fn=cmd_version)

    args = p.parse_args(argv)
    glog.init_from_flags(args)
    if args.cpuprofile or args.memprofile:
        from .util.profiling import setup_profiling

        setup_profiling(args.cpuprofile, args.memprofile)
    args.fn(args)


def _add_metrics_flags(parser) -> None:
    parser.add_argument("-metrics.address", dest="metrics_address", default="",
                        help="Prometheus push gateway host:port (push loop)")
    parser.add_argument("-metrics.intervalSeconds", dest="metrics_interval", type=float,
                        default=15.0)


def _add_volume_file_flags(parser) -> None:
    """The flags that name a volume's files on disk (the offline tools)."""
    parser.add_argument("-dir", default=".")
    parser.add_argument("-collection", default="")
    parser.add_argument("-volumeId", dest="volume_id", type=int, required=True)


if __name__ == "__main__":
    main()
