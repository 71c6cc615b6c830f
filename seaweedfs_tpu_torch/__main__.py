"""Command line: ``python -m seaweedfs_tpu_torch
master|volume|shell|backup|compact|volume.tail ...``.

- ``master`` runs a single master with the flags of ``weed master``: ``-ip
  -port -volumeSizeLimitMB -defaultReplication``. ``-peers`` and ``-mdir``
  (election and its state directory) are refused as not ported yet.
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

The daemons run until SIGINT or SIGTERM, then stop cleanly.
"""

from __future__ import annotations

import argparse
import signal
import threading


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

    for flag, val in (("-peers", args.peers), ("-mdir", args.mdir)):
        if val:
            raise SystemExit(f"master: {flag} is not ported yet "
                             "(the port runs one master, its own leader)")
    ms = MasterServer(
        host=args.ip,
        port=args.port,
        volume_size_limit_mb=args.volume_size_limit_mb,
        default_replication=args.default_replication,
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
    m.add_argument("-peers", default="", help="not ported yet")
    m.add_argument("-mdir", default="", help="not ported yet")
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

    args = p.parse_args(argv)
    glog.set_verbosity(args.v)
    args.fn(args)


if __name__ == "__main__":
    main()
