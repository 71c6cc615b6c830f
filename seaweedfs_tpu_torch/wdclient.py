"""Client-side master helpers (weed/wdclient).

Only ``find_reachable_master``, which the shell's ``CommandEnv`` pins its
master with. ``MasterClient`` (the cached vid map kept fresh from the
master's ``/cluster/watch`` feed) is not ported yet.
"""

from __future__ import annotations

from .server.http_util import http_json


def find_reachable_master(seeds: list[str], timeout: float = 2.0,
                          strict: bool = False) -> str:
    """First seed answering /cluster/status. Reachable beats leader-guessing:
    never pin to an address nobody verified. When none answer: '' under
    strict (callers that must not act on an unverified address), else the
    first seed."""
    for m in seeds:
        try:
            http_json("GET", f"http://{m}/cluster/status", timeout=timeout)
            return m
        except Exception:  # noqa: BLE001 — an unreachable seed is the expected case
            continue
    if strict:
        return ""
    return seeds[0] if seeds else ""
