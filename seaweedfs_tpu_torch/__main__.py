"""Command line: ``python -m seaweedfs_tpu_torch volume ...``.

The ``volume`` subcommand runs a volume server with the flags of
``weed volume`` (and of the JAX package's CLI): ``-ip -port -dir -mserver
-dataCenter -rack -max -pulseSeconds -index``. ``-ec.backend`` is ``cuda``
(the default: the hand-written kernel, and EC requests fail without a card)
or ``cpu`` (the kernel's plain PyTorch version). The server runs until
SIGINT or SIGTERM, then stops cleanly.
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
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    vs.start()
    print(f"volume server on {vs.host}:{vs.port} -> master {args.mserver} "
          f"(ec backend {vs.store.ec_backend})", flush=True)
    try:
        stop.wait()
    finally:
        vs.stop()


def main(argv=None) -> None:
    from .util import glog

    p = argparse.ArgumentParser(prog="seaweedfs_tpu_torch")
    p.add_argument("-v", type=int, default=0, metavar="LEVEL",
                   help="log verbosity for V-gated messages")
    sub = p.add_subparsers(dest="cmd", required=True)

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

    args = p.parse_args(argv)
    glog.set_verbosity(args.v)
    args.fn(args)


if __name__ == "__main__":
    main()
