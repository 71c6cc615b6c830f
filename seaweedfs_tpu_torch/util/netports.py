"""Ports for daemons run as subprocesses: allocate, record, retry on
EADDRINUSE (the JAX package's ``util/netports.py``).

A harness that runs daemons in child processes, and relaunches them, keeps
their ports in a ``ports.json`` so that every incarnation binds the same
ones. A relaunch can race the previous incarnation's sockets out of
TIME_WAIT (or another process can hold the port a moment), and the bind
fails with ``EADDRINUSE`` on a condition that clears itself in
milliseconds.

:func:`start_on_port` retries the same port with jittered backoff first.
Only when it stays taken does it fall back to a fresh one
(``fallback=True``, where the state is disposable) or raise
(``fallback=False``, where a moved port would orphan state keyed by it).
:func:`record` writes the ports finally bound back to ``ports.json``.
"""

from __future__ import annotations

import errno
import json
import os
import random
import socket
import time
from typing import Callable, Optional


def free_port(host: str = "127.0.0.1") -> int:
    s = socket.socket()
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port


def load_or_allocate(ports_file: str, names: list[str],
                     host: str = "127.0.0.1") -> dict:
    """The run's port map: reloaded verbatim when ``ports_file`` exists
    (a relaunched incarnation must reuse its ports), else freshly
    allocated and written."""
    if os.path.exists(ports_file):
        with open(ports_file) as f:
            return json.load(f)
    ports = {name: free_port(host) for name in names}
    record(ports_file, ports)
    return ports


def record(ports_file: str, ports: dict) -> None:
    """Persist the FINAL bound ports (write-then-rename so a reader never
    sees a torn map)."""
    tmp = ports_file + ".tmp"
    with open(tmp, "w") as f:
        json.dump(ports, f)
    os.replace(tmp, ports_file)


def _is_addr_in_use(exc: OSError) -> bool:
    if exc.errno == errno.EADDRINUSE:
        return True
    # servers that wrap the bind error lose errno; match the message the
    # way a human rerunning the test would
    return "address already in use" in str(exc).lower()


def start_on_port(
    factory: Callable[[int], object],
    port: int,
    attempts: int = 6,
    base_backoff_s: float = 0.1,
    fallback: bool = False,
    host: str = "127.0.0.1",
    rng: Optional[random.Random] = None,
) -> tuple[object, int]:
    """Call ``factory(port)`` (which binds + returns the started server),
    retrying EADDRINUSE on the SAME port with jittered exponential
    backoff. Returns ``(server, bound_port)``.

    After ``attempts`` the port is considered squatted: with
    ``fallback=True`` one fresh port is tried (probes; the caller then
    :func:`record`\\ s the new map), otherwise the last error raises
    (crash harnesses — port-keyed state must not silently move)."""
    rng = rng or random.Random()
    last: Optional[OSError] = None
    for attempt in range(attempts):
        try:
            return factory(port), port
        except OSError as e:
            if not _is_addr_in_use(e):
                raise
            last = e
            # full jitter: spread relaunch herds instead of re-colliding
            time.sleep(rng.uniform(0, base_backoff_s * (2 ** attempt)))
    if fallback:
        fresh = free_port(host)
        return factory(fresh), fresh
    raise last
