"""VolumeLayout: writable/readonly volume sets per (collection, rp, ttl).

Mirrors `weed/topology/volume_layout.go`: tracks vid → replica locations and
keeps the writable list consistent with replica counts and sizes.  Where the
reference picks writables uniformly at random, this layout weights the pick
by free space over volume heat (the EWMA counters volume servers ship in
heartbeats — stats/heat.py) and skips volumes whose every replica sits on an
overloaded node, so zipfian read storms stop attracting new writes to the
nodes already melting (the f4 observation).  The JAX package makes the same
choice, and its docs/PARITY.md records the divergence.
"""

from __future__ import annotations

import os
import random
from typing import TYPE_CHECKING, Optional

from ..storage.replica_placement import ReplicaPlacement
from ..storage.ttl import TTL
from ..util.locks import make_rlock
from ..util.parsers import tolerant_ufloat

if TYPE_CHECKING:
    from .topology import DataNode, VolumeInfo

# module-level RNG so placement is seedable in tests (seed_placement) and
# no pick path reaches for the process-global `random` state
_rng = random.Random()

# a node is overloaded when its heat exceeds this multiple of the mean
# node heat among the current candidates' replica holders
OVERLOAD_FACTOR = 2.0


def seed_placement(seed=None) -> None:
    """Seed the placement RNG — deterministic writable picks for tests."""
    _rng.seed(seed)


# -- lifecycle heat thresholds (f4's hot→warm→cold bands) ---------------------
# The lifecycle controller (cluster/lifecycle.py) classifies every volume by its
# EWMA heat against three thresholds, env-tunable so probes and small
# clusters can shrink the bands:
#   heat >  ceiling                         hot   — un-EC / replica-boost
#   floor <= heat <= ceiling                warm  — leave alone
#   tier_floor <= heat < floor (streak)     cool  — fleet-EC, replicas reclaimed
#   heat <  tier_floor         (streak)     cold  — tier the bytes to S3
def heat_floor() -> float:
    """Below this a plain volume is cooling toward the EC (warm) tier."""
    return tolerant_ufloat(os.environ.get("SWEED_HEAT_FLOOR", ""), 0.05)


def heat_ceiling() -> float:
    """Above this an EC volume is hot enough to un-EC (or replica-boost)."""
    return tolerant_ufloat(os.environ.get("SWEED_HEAT_CEILING", ""), 50.0)


def tier_floor() -> float:
    """Below this a volume is cold enough for the S3 tier (must be below
    heat_floor to mean anything)."""
    return tolerant_ufloat(os.environ.get("SWEED_TIER_FLOOR", ""), 0.005)


def classify_heat(
    heat: float,
    floor: Optional[float] = None,
    ceiling: Optional[float] = None,
    cold: Optional[float] = None,
) -> str:
    """Heat value → band name: "hot" | "warm" | "cool" | "cold"."""
    floor = heat_floor() if floor is None else floor
    ceiling = heat_ceiling() if ceiling is None else ceiling
    cold = tier_floor() if cold is None else cold
    if heat > ceiling:
        return "hot"
    if heat >= floor:
        return "warm"
    if heat >= cold:
        return "cool"
    return "cold"


class VolumeLayout:
    def __init__(
        self,
        rp: ReplicaPlacement,
        ttl: TTL,
        volume_size_limit: int,
    ):
        self.rp = rp
        self.ttl = ttl
        self.volume_size_limit = volume_size_limit
        self.vid2location: dict[int, list["DataNode"]] = {}
        self.writables: list[int] = []
        self.readonly_volumes: set[int] = set()
        self.oversized_volumes: set[int] = set()
        # vid → read+write heat, refreshed from every heartbeat's
        # VolumeInfo; feeds the weighted pick below
        self.volume_heat: dict[int, float] = {}
        self._lock = make_rlock("VolumeLayout._lock")

    # -- registration (volume_layout.go:104-200) -----------------------------
    def register_volume(self, vi: "VolumeInfo", dn: "DataNode") -> None:
        with self._lock:
            locs = self.vid2location.setdefault(vi.id, [])
            if dn not in locs:
                locs.append(dn)
            self.ensure_correct_writables(vi)

    def unregister_volume(self, vi: "VolumeInfo", dn: "DataNode") -> None:
        with self._lock:
            locs = self.vid2location.get(vi.id)
            if locs and dn in locs:
                locs.remove(dn)
            if not locs:
                self.vid2location.pop(vi.id, None)
                self.volume_heat.pop(vi.id, None)
                self._remove_from_writable(vi.id)
            else:
                self._ensure_writable_state(vi.id)

    def ensure_correct_writables(self, vi: "VolumeInfo") -> None:
        with self._lock:
            self.volume_heat[vi.id] = vi.read_heat + vi.write_heat
            if vi.read_only:
                self.readonly_volumes.add(vi.id)
            else:
                self.readonly_volumes.discard(vi.id)
            if vi.size >= self.volume_size_limit:
                self.oversized_volumes.add(vi.id)
            else:
                # a vacuumed volume can shrink back under the limit
                self.oversized_volumes.discard(vi.id)
            self._ensure_writable_state(vi.id)

    def _ensure_writable_state(self, vid: int) -> None:
        locs = self.vid2location.get(vid, [])
        enough_replicas = len(locs) >= self.rp.copy_count()
        writable = (
            enough_replicas
            and vid not in self.readonly_volumes
            and vid not in self.oversized_volumes
        )
        if writable:
            if vid not in self.writables:
                self.writables.append(vid)
        else:
            self._remove_from_writable(vid)

    def _remove_from_writable(self, vid: int) -> None:
        if vid in self.writables:
            self.writables.remove(vid)

    def set_volume_unavailable(self, vid: int, dn: "DataNode") -> bool:
        """Node lost (volume_layout.go:357): drop this replica; volume leaves
        the writable set when replicas fall below the placement count."""
        with self._lock:
            locs = self.vid2location.get(vid)
            if locs and dn in locs:
                locs.remove(dn)
            if not locs:
                self.vid2location.pop(vid, None)
                self.volume_heat.pop(vid, None)
            self._ensure_writable_state(vid)
            return vid in self.writables

    def set_volume_readonly(self, vid: int) -> None:
        with self._lock:
            self.readonly_volumes.add(vid)
            self._remove_from_writable(vid)

    # -- assignment (volume_layout.go:267-300, heat-weighted divergence) -----
    def pick_for_write(
        self, data_center: str = ""
    ) -> tuple[int, list["DataNode"]]:
        with self._lock:
            if not self.writables:
                raise NoWritableVolumesError("no more writable volumes")
            candidates = []
            for vid in self.writables:
                locs = self.vid2location.get(vid, [])
                if data_center and not any(
                    dn.get_data_center().id == data_center for dn in locs
                ):
                    continue
                candidates.append((vid, locs))
            if not candidates:
                raise NoWritableVolumesError(
                    f"no writable volumes in data center {data_center}"
                )
            candidates = self._drop_overloaded(candidates)
            vid, locs = self._weighted_pick(candidates)
            return vid, list(locs)

    def _drop_overloaded(self, candidates):
        """Skip volumes whose every replica sits on an overloaded node
        (node heat > OVERLOAD_FACTOR × mean over candidate holders).
        Falls back to the full list when the filter would empty it —
        degraded placement still beats NoWritableVolumesError."""
        node_heat: dict["DataNode", float] = {}
        for vid, locs in candidates:
            h = self.volume_heat.get(vid, 0.0)
            for dn in locs:
                node_heat[dn] = node_heat.get(dn, 0.0) + h
        if len(node_heat) < 2:
            return candidates
        mean = sum(node_heat.values()) / len(node_heat)
        if mean <= 0.0:
            return candidates
        overloaded = {
            dn for dn, h in node_heat.items() if h > OVERLOAD_FACTOR * mean
        }
        if not overloaded:
            return candidates
        kept = [
            (vid, locs)
            for vid, locs in candidates
            if locs and not all(dn in overloaded for dn in locs)
        ]
        return kept or candidates

    def _weighted_pick(self, candidates):
        """Sample one candidate ∝ free-space / (1 + heat): cold volumes on
        roomy nodes absorb new writes, hot ones cool off.  With no heat
        and uniform free space this degrades to the reference's uniform
        random pick."""
        weights = []
        for vid, locs in candidates:
            free = min((dn.free_space() for dn in locs), default=0)
            heat = self.volume_heat.get(vid, 0.0)
            weights.append((1.0 + max(0, free)) / (1.0 + heat))
        total = sum(weights)
        if total <= 0.0:
            return candidates[_rng.randrange(len(candidates))]
        r = _rng.random() * total
        for pair, w in zip(candidates, weights):
            r -= w
            if r <= 0.0:
                return pair
        return candidates[-1]

    def active_volume_count(self) -> int:
        return len(self.writables)

    def stats(self) -> dict:
        with self._lock:
            return {
                "replication": str(self.rp),
                "ttl": str(self.ttl),
                "writables": sorted(self.writables),
                "readonly": sorted(self.readonly_volumes),
                "oversized": sorted(self.oversized_volumes),
                "volume_count": len(self.vid2location),
                "heat": {
                    str(vid): round(h, 3)
                    for vid, h in sorted(self.volume_heat.items())
                    if h > 0.0
                },
            }


class NoWritableVolumesError(Exception):
    pass
