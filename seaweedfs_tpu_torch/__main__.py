"""Command line: ``python -m seaweedfs_tpu_torch
master|volume|filer|s3|filer.sync|filer.replicate|watch|shell|upload|download|delete|backup|
compact|volume.tail|benchmark ...``.

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
  (``server/volume_server.py``).
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
- ``filer.sync -a A -b B [-a.path -b.path -isActivePassive]`` keeps two
  filer clusters in sync (``replication/filer_sync.py``), both ways unless
  ``-isActivePassive``.
- ``filer.replicate -filer F [-source] [-sink.dir | -sink.s3]`` mirrors a
  filer's meta events into a sink (``replication.toml``'s, else the flags).
- ``watch -filer F [-v]`` prints a filer's meta events as they come.
- ``upload -master [-maxMB] FILE...``, ``download -master [-o] FID`` and
  ``delete -master FID...`` are the object-store client of ``operation.py``.
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


def _serve_until_signalled(*servers) -> None:
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    try:
        stop.wait()
    finally:
        for server in servers:
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
                   choices=["memory", "dense", "sqlite", "sorted", "mmap"],
                   help="needle map kind: memory, dense (16 B an entry), sqlite "
                        "(<vol>.ldb), sorted (read-only <vol>.sdx), mmap (<vol>.mdx)")
    v.add_argument("-ec.backend", dest="ec_backend", default="cuda",
                   choices=["cuda", "cpu", "mesh"],
                   help="cuda: the hand-written GPU kernel; cpu: its plain version; "
                        "mesh: the kernel on every local GPU (ec/sharded.py)")
    v.set_defaults(fn=cmd_volume)

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
