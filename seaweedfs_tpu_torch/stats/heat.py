"""Per-volume read/write heat: exponentially-decayed op counters.

Every volume carries two ``EwmaHeat`` counters (reads, writes), marked on the
store's data-plane routing; the decayed values ride the heartbeat to the
master (``Store._volume_message``), which folds them into placement. EC
volumes keep their read heat in the store (``Store.ec_read_heat``).
"""

from __future__ import annotations

import os
import time
import weakref

from ..util.locks import make_lock
from ..util.parsers import tolerant_ufloat
from ..util.racecheck import instrument

# one half-life of inactivity halves a volume's heat. SWEED_HEAT_HALFLIFE
# (seconds, read at import) overrides it; garbage, negative, non-finite and
# zero values keep the 60 s default.
HEAT_HALFLIFE_SECONDS = tolerant_ufloat(
    os.environ.get("SWEED_HEAT_HALFLIFE", ""), 60.0
) or 60.0


@instrument
class EwmaHeat:
    """Exponentially-decayed op counter: an op marked now weighs 1, an op a
    half-life ago weighs 0.5."""

    __slots__ = ("halflife", "_v", "_t", "_lock")

    def __init__(self, halflife: float = HEAT_HALFLIFE_SECONDS):
        self.halflife = halflife
        self._v = 0.0
        self._t = time.monotonic()
        self._lock = make_lock("EwmaHeat._lock")

    def _decay_locked(self) -> None:
        now = time.monotonic()
        dt = now - self._t
        if dt > 0.0:
            self._v *= 0.5 ** (dt / self.halflife)
            self._t = now

    def mark(self, n: float = 1.0) -> None:
        with self._lock:
            self._decay_locked()
            self._v += n

    def value(self) -> float:
        with self._lock:
            self._decay_locked()
            return self._v


# live stores register here so heat_stats() can aggregate without holding
# the stores alive
_stores: "weakref.WeakSet" = weakref.WeakSet()


def register_store(store) -> None:
    _stores.add(store)


def heat_stats() -> dict:
    """Heat summed over every live store of this process (the volume
    server's /status heat section)."""
    read = write = max_volume = 0.0
    volumes = 0
    for store in list(_stores):
        for loc in store.locations:
            for v in list(loc.volumes.values()):
                r, w = v.read_heat.value(), v.write_heat.value()
                read += r
                write += w
                volumes += 1
                max_volume = max(max_volume, r + w)
    return {
        "read_heat": round(read, 3),
        "write_heat": round(write, 3),
        "max_volume_heat": round(max_volume, 3),
        "volumes": volumes,
    }
