"""Command line: ``python -m seaweedfs_tpu_torch master|volume|shell ...``.

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

    args = p.parse_args(argv)
    glog.set_verbosity(args.v)
    args.fn(args)


if __name__ == "__main__":
    main()
