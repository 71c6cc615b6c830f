"""Heat-driven lifecycle autopilot: the master's observe→plan→execute loop.

f4's thesis is that blob storage is a *lifecycle*: content is born hot
(triple-replicated, served from page cache), cools within weeks (erasure
coding recovers the replica overhead), and ends cold (bytes belong on the
cheapest tier that still answers reads). The reference leaves every one of
those transitions to an operator typing shell commands; this controller
closes the loop. It runs ONLY on the elected leader and each cycle:

* **observe** — walks the heartbeat-fresh topology: per-volume EWMA heat
  (stats/heat.py rides every beat), garbage ratio, replica set, EC shard
  map, remote-tier flag, and the scrub's corrupt needle/shard findings;
* **plan** — classifies each volume into a heat band
  (volume_layout.classify_heat) and emits a bounded action list, priority
  ordered: repair corruption first, then vacuum garbage, re-promote hot EC
  volumes, recall warming tiered volumes, EC cooling volumes, tier cold
  ones to the S3-class backend, and replica-boost hot plain volumes;
* **execute** — every action goes through the same staged-commit-protected
  paths the shell uses (fleet scheduler for EC, /admin/tier_* for the S3
  tier), so a daemon death mid-action leaves the volume fully in its old
  state or fully in its new one, never torn.

Safety interlocks, in the order they gate a cycle:

1. **pause switch** — ``lifecycle.pause`` flips an in-memory flag; the
   controller finishes nothing new until ``lifecycle.resume``.
2. **load interlock** — maintenance yields to traffic: when the admission
   controller's inflight gauge crosses a fraction of the serving watermark
   (server/http_util.py), the cycle defers. Re-checked before EVERY action,
   so a traffic spike mid-cycle stops the remaining moves.
3. **admin lease** — the controller leases the cluster admin lock around a
   cycle; a shell operator holding ``lock`` pauses the autopilot for free.
4. **plan journal** — an fsync'd single-document journal
   (``lifecycle_{port}.json`` next to the election state) records the plan
   before execution and every per-action state transition. A restarted or
   failed-over master replays it: actions that never started are abandoned
   (the next observation re-derives them if still warranted), actions
   caught mid-flight are re-validated against a FRESH observation and only
   re-executed when the volume still needs them — double-scheduling is
   structurally impossible because the predicate is current state, not the
   stale plan.
5. **budgets** — a global per-cycle action cap plus per-kind token budgets
   bound the blast radius of any single cycle; per-volume cooldown cycles
   stop flapping (a volume just EC'd cannot be un-EC'd next cycle).

Faultpoints (``lifecycle.journal.planned`` / ``.running`` / ``.done`` /
``.cycle`` / ``.recovered``) fire after each journal write so the chaos
matrix (tests/test_lifecycle_chaos.py) can kill the master at every
crash window and assert no torn tier state and no duplicated moves.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..server.http_util import SERVING, http_json, serving_watermark
from ..shell import commands as C
from ..stats.metrics import default_registry as _registry
from ..storage.commit import atomic_write
from ..util import faultpoints, glog
from ..util.locks import make_lock
from ..util.parsers import tolerant_ufloat, tolerant_uint
from .volume_layout import classify_heat, heat_ceiling, heat_floor, tier_floor

#: wall time of one observe→plan→execute cycle
CYCLE_HIST = _registry.histogram(
    "lifecycle_cycle_seconds",
    "lifecycle controller cycle latency (observe through journal close)",
)
#: per-action execution latency, labeled by action kind
ACTION_HIST = _registry.histogram(
    "lifecycle_action_seconds",
    "lifecycle action execution latency, by kind",
)

#: action kinds in planning priority order (repairs always first)
ACTION_KINDS = (
    "repair_shard",
    "repair_replica",
    "vacuum",
    "un_ec",
    "tier_down",
    "tier_up",
    "ec",
    "replica_boost",
)


@dataclass
class LifecycleConfig:
    """Knobs, all env-tunable so probes/chaos runs shrink the time scales."""

    interval: float = 30.0  # seconds between cycles
    cold_streak: int = 3  # consecutive cool/cold observations before EC/tier
    max_actions: int = 4  # global per-cycle concurrent-moves cap
    cooldown_cycles: int = 3  # per-volume quiet period after any action
    garbage_threshold: float = 0.3
    hot_replicas: int = 0  # replica-boost target; 0 disables boosting
    load_fraction: float = 0.5  # inflight ≥ fraction×watermark ⇒ defer
    tier_endpoint: str = ""  # S3 tier; empty ⇒ tiering disabled
    tier_bucket: str = "sweed-cold"
    tier_backend: str = ""
    budgets: dict = field(
        default_factory=lambda: {
            "repair_shard": 2,
            "repair_replica": 2,
            "vacuum": 2,
            "un_ec": 1,
            "tier_down": 2,
            "tier_up": 1,
            "ec": 2,
            "replica_boost": 1,
        }
    )

    @classmethod
    def from_env(cls) -> "LifecycleConfig":
        cfg = cls(
            interval=tolerant_ufloat(
                os.environ.get("SWEED_LIFECYCLE_INTERVAL", ""), 30.0
            )
            or 30.0,
            cold_streak=max(
                1,
                tolerant_uint(os.environ.get("SWEED_LIFECYCLE_COLD_STREAK"), 3),
            ),
            max_actions=max(
                1,
                tolerant_uint(os.environ.get("SWEED_LIFECYCLE_MAX_ACTIONS"), 4),
            ),
            cooldown_cycles=tolerant_uint(
                os.environ.get("SWEED_LIFECYCLE_COOLDOWN"), 3
            ),
            garbage_threshold=tolerant_ufloat(
                os.environ.get("SWEED_LIFECYCLE_GARBAGE", ""), 0.3
            ),
            hot_replicas=tolerant_uint(
                os.environ.get("SWEED_LIFECYCLE_HOT_REPLICAS"), 0
            ),
            load_fraction=tolerant_ufloat(
                os.environ.get("SWEED_LIFECYCLE_LOAD_FRACTION", ""), 0.5
            )
            or 0.5,
            tier_endpoint=os.environ.get("SWEED_TIER_ENDPOINT", ""),
            tier_bucket=os.environ.get("SWEED_TIER_BUCKET", "sweed-cold"),
            tier_backend=os.environ.get("SWEED_TIER_BACKEND", ""),
        )
        # "ec=4,vacuum=0" style per-kind token overrides
        for part in os.environ.get("SWEED_LIFECYCLE_BUDGETS", "").split(","):
            if "=" in part:
                kind, _, n = part.partition("=")
                if kind.strip() in cfg.budgets:
                    cfg.budgets[kind.strip()] = tolerant_uint(n.strip(), 0)
        return cfg


class LoadInterlock:
    """Maintenance yields to traffic: reads the admission controller's
    inflight gauge against the serving watermark (server/http_util.py).
    The controller consults this before the cycle AND before every action."""

    def __init__(self, fraction: float = 0.5):
        self.fraction = fraction
        self.last_reason = ""

    def maintenance_allowed(self) -> tuple[bool, str]:
        watermark = serving_watermark()
        limit = max(1, int(self.fraction * watermark))
        inflight = SERVING.inflight()
        if inflight >= limit:
            self.last_reason = (
                f"inflight {inflight} >= {limit} "
                f"({self.fraction:.0%} of watermark {watermark})"
            )
            return False, self.last_reason
        self.last_reason = ""
        return True, ""


def observe_topology(master_server) -> dict[int, dict]:
    """One observation pass over the master's heartbeat-fresh topology:
    vid → {kind, heat, band, garbage, replicas, tiered, corrupt, ...}.
    Pure read — defensive copies, no locks held across the return."""
    topo = master_server.master.topo
    obs: dict[int, dict] = {}
    for dn in topo.data_nodes():
        url = dn.url()
        for vid, vi in list(dn.volumes.items()):
            ob = obs.setdefault(
                vid,
                {
                    "vid": vid,
                    "collection": vi.collection,
                    "kind": "plain",
                    "heat": 0.0,
                    "garbage": 0.0,
                    "size": 0,
                    "replicas": [],
                    "tiered": False,
                    "read_only": False,
                    "corrupt_needles": {},
                    "ec_shards": {},
                    "corrupt_shards": {},
                },
            )
            ob["kind"] = "plain"  # a plain replica wins over shard leftovers
            ob["replicas"].append(url)
            ob["heat"] = max(ob["heat"], vi.read_heat + vi.write_heat)
            ob["size"] = max(ob["size"], vi.size)
            if vi.size > 0:
                ob["garbage"] = max(
                    ob["garbage"], vi.deleted_byte_count / vi.size
                )
            ob["tiered"] = ob["tiered"] or vi.remote_tier
            ob["read_only"] = ob["read_only"] or vi.read_only
            if vi.corrupt_needles:
                ob["corrupt_needles"][url] = vi.corrupt_needles
        for vid, bits in list(dn.ec_shards.items()):
            ob = obs.setdefault(
                vid,
                {
                    "vid": vid,
                    "collection": dn.ec_collections.get(vid, ""),
                    "kind": "ec",
                    "heat": 0.0,
                    "garbage": 0.0,
                    "size": 0,
                    "replicas": [],
                    "tiered": False,
                    "read_only": False,
                    "corrupt_needles": {},
                    "ec_shards": {},
                    "corrupt_shards": {},
                },
            )
            ob["ec_shards"][url] = bits
            ob["heat"] = max(ob["heat"], dn.ec_read_heat.get(vid, 0.0))
            sids = dn.ec_corrupt.get(vid)
            if sids:
                ob["corrupt_shards"][url] = list(sids)
    for ob in obs.values():
        ob["band"] = classify_heat(ob["heat"])
    return obs


class ClusterOps:
    """Real executor: every action dogfoods the HTTP control plane the
    shell uses (the controller runs only on the leader, so ``master_url``
    is the local daemon). Each op is idempotent against current state —
    re-executing a completed action is a no-op or a cheap error."""

    def __init__(self, master_url: str, cfg: LifecycleConfig):
        self.master_url = master_url
        self.cfg = cfg
        self._env = None

    def _commands(self):
        if self._env is None:
            self._env = C.CommandEnv(self.master_url)
        return C, self._env

    def execute(self, action: dict, ob: dict) -> None:
        getattr(self, "_op_" + action["kind"])(action, ob)

    def _op_ec(self, action, ob) -> None:
        C, env = self._commands()
        C.ec_encode_fleet(env, [ob["vid"]], ob["collection"] or None)

    def _op_un_ec(self, action, ob) -> None:
        C, env = self._commands()
        C.ec_decode(env, ob["vid"], ob["collection"])

    def _op_vacuum(self, action, ob) -> None:
        for url in ob["replicas"]:
            r = http_json(
                "POST",
                f"http://{url}/admin/vacuum?volume={ob['vid']}",
            )
            if r.get("error"):
                raise RuntimeError(f"vacuum on {url}: {r['error']}")

    def _op_tier_up(self, action, ob) -> None:
        C, env = self._commands()
        if ob["kind"] == "ec":
            # demote-through-decode: a cold EC volume re-materializes as a
            # plain volume first, then its .dat moves to the S3 tier
            C.ec_decode(env, ob["vid"], ob["collection"])
        C.volume_tier_upload(
            env,
            ob["vid"],
            self.cfg.tier_endpoint,
            self.cfg.tier_bucket,
            keep_local=False,
            backend=self.cfg.tier_backend,
        )

    def _op_tier_down(self, action, ob) -> None:
        C, env = self._commands()
        C.volume_tier_download(env, ob["vid"])

    def _op_repair_shard(self, action, ob) -> None:
        C, env = self._commands()
        for url, sids in ob["corrupt_shards"].items():
            shards = ",".join(str(s) for s in sids)
            r = http_json(
                "POST",
                f"http://{url}/admin/ec/delete_shards?volume={ob['vid']}"
                f"&shards={shards}",
            )
            if r.get("error"):
                raise RuntimeError(f"drop corrupt shards on {url}: {r['error']}")
        # ec.rebuild rebuilds what the master lists as missing: wait for the
        # drop's delta beat first. The JAX package asks at once, and when
        # the master still lists the dropped shard it rebuilds nothing; the
        # finding is gone with the shard, so the shard stays lost.
        deadline = time.monotonic() + 30.0
        while any(url in env.ec_shard_locations(ob["vid"]).get(sid, [])
                  for url, sids in ob["corrupt_shards"].items() for sid in sids):
            if time.monotonic() > deadline:
                raise RuntimeError(f"volume {ob['vid']}: the master still lists the "
                                   "dropped shards")
            time.sleep(0.1)
        C.ec_rebuild(env, ob["vid"], ob["collection"])

    def _op_repair_replica(self, action, ob) -> None:
        C, env = self._commands()
        healthy = [
            u for u in ob["replicas"] if u not in ob["corrupt_needles"]
        ]
        if not healthy:
            raise RuntimeError(
                f"volume {ob['vid']}: every replica reports corruption; "
                "needs a fleet rebuild from EC parity, not a re-fetch"
            )
        for url in ob["corrupt_needles"]:
            r = http_json(
                "POST",
                f"http://{url}/admin/delete_volume?volume={ob['vid']}",
            )
            if r.get("error"):
                raise RuntimeError(
                    f"drop corrupt replica on {url}: {r['error']}"
                )
            C.volume_copy(env, ob["vid"], target=url, source=healthy[0])

    def _op_replica_boost(self, action, ob) -> None:
        C, env = self._commands()
        holders = set(ob["replicas"])
        spare = [
            n["url"] for n in env.data_nodes() if n["url"] not in holders
        ]
        if not spare:
            raise RuntimeError(
                f"volume {ob['vid']}: no spare node for a replica boost"
            )
        C.volume_copy(env, ob["vid"], target=spare[0])


class LifecycleController:
    """The autopilot. Everything injectable for unit tests: ``observe``
    returns the vid→observation map, ``ops.execute(action, ob)`` performs
    one action, ``clock`` stamps the journal, ``is_leader`` gates cycles,
    ``lease``/``release`` wrap the master's admin lock."""

    def __init__(
        self,
        *,
        journal_path: Optional[str] = None,
        config: Optional[LifecycleConfig] = None,
        observe: Optional[Callable[[], dict]] = None,
        ops=None,
        is_leader: Callable[[], bool] = lambda: True,
        clock: Callable[[], float] = time.time,
        interlock: Optional[LoadInterlock] = None,
        lease: Optional[Callable[[str], str]] = None,
        release: Optional[Callable[[str], None]] = None,
    ):
        self.cfg = config or LifecycleConfig.from_env()
        self.journal_path = journal_path
        self._observe = observe or (lambda: {})
        self.ops = ops
        self._is_leader = is_leader
        self._clock = clock
        self.interlock = interlock or LoadInterlock(self.cfg.load_fraction)
        self._lease = lease
        self._release = release
        self._lock = make_lock("LifecycleController._lock")
        self._paused = False
        self._cycle = 0
        self._next_id = 1
        self._cold_streak: dict[int, int] = {}
        self._cooldown: dict[int, int] = {}  # vid → cycle it unlocks at
        self._resume_queue: list[dict] = []
        self._last_actions: list[dict] = []
        self._last_cycle_at = 0.0
        self._last_cycle_seconds = 0.0
        self.recovery: dict = {}
        self._recovered = False
        self._counters = {
            "cycles": 0,
            "actions_done": 0,
            "actions_failed": 0,
            "actions_deferred": 0,
            "cycles_deferred": 0,
            "cycles_skipped_locked": 0,
            "resumed": 0,
            "abandoned": 0,
        }
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        _register(self)

    # -- pause / resume -------------------------------------------------------
    def pause(self) -> None:
        with self._lock:
            self._paused = True

    def resume(self) -> None:
        with self._lock:
            self._paused = False

    @property
    def paused(self) -> bool:
        with self._lock:
            return self._paused

    # -- plan journal ---------------------------------------------------------
    def _persist(self, doc: dict, fp: str) -> None:
        """Journal write + chaos window: the faultpoint fires AFTER the
        fsync'd rename, so an armed crash simulates dying with exactly
        this state durable."""
        if not self.journal_path:
            return
        atomic_write(
            self.journal_path,
            json.dumps(doc, sort_keys=True).encode(),
        )
        faultpoints.fire(fp, self.journal_path)

    def _load_journal(self) -> Optional[dict]:
        if not self.journal_path or not os.path.exists(self.journal_path):
            return None
        try:
            with open(self.journal_path, "rb") as f:
                return json.loads(f.read())
        except (OSError, ValueError) as e:
            glog.warning("lifecycle: unreadable journal %s: %s",
                         self.journal_path, e)
            return None

    def _recover(self) -> None:
        """Leadership (re)gain: resolve any in-flight cycle the previous
        incarnation left in the journal. Planned-never-started actions are
        abandoned — the next observation re-derives them if still needed.
        Running actions go to the resume queue, where the next cycle
        re-validates them against a FRESH observation before re-executing
        (idempotent roll-forward; a completed action fails the predicate
        and becomes a no-op, so nothing is ever double-scheduled)."""
        self._recovered = True
        doc = self._load_journal()
        if not doc or doc.get("state") == "done":
            return
        running = [a for a in doc.get("actions", []) if a["state"] == "running"]
        abandoned = [
            a for a in doc.get("actions", []) if a["state"] == "planned"
        ]
        recovery = {
            "cycle": doc.get("cycle", 0),
            "resumed": len(running),
            "abandoned": len(abandoned),
            "at": self._clock(),
        }
        with self._lock:
            self._resume_queue = running
            self._cycle = max(self._cycle, doc.get("cycle", 0))
            self._counters["resumed"] += len(running)
            self._counters["abandoned"] += len(abandoned)
            self.recovery = recovery
        glog.info(
            "lifecycle: recovered journal cycle %d (%d resumed, %d abandoned)",
            doc.get("cycle", 0), len(running), len(abandoned),
        )
        self._persist(
            {
                "cycle": doc.get("cycle", 0),
                "state": "done",
                "recovered": recovery,
                "actions": doc.get("actions", []),
            },
            "lifecycle.journal.recovered",
        )

    # -- planning -------------------------------------------------------------
    def _still_needed(self, action: dict, obs: dict) -> bool:
        """Re-validate an action against the CURRENT observation. Gates
        both resumed actions and fresh ones at execution time — the
        predicate is present state, so replaying a journal (or a stale
        plan racing a completed move) cannot duplicate work."""
        ob = obs.get(action["vid"])
        if ob is None:
            return False
        kind = action["kind"]
        if kind == "ec":
            return ob["kind"] == "plain" and not ob["tiered"]
        if kind == "un_ec":
            return ob["kind"] == "ec"
        if kind == "tier_up":
            return not ob["tiered"] and bool(self.cfg.tier_endpoint)
        if kind == "tier_down":
            return ob["tiered"]
        if kind == "vacuum":
            return (
                ob["kind"] == "plain"
                and ob["garbage"] >= self.cfg.garbage_threshold
            )
        if kind == "repair_shard":
            return bool(ob["corrupt_shards"])
        if kind == "repair_replica":
            return bool(ob["corrupt_needles"]) and len(
                ob["corrupt_needles"]
            ) < len(ob["replicas"])
        if kind == "replica_boost":
            return (
                ob["kind"] == "plain"
                and 0 < len(ob["replicas"]) < self.cfg.hot_replicas
            )
        return False

    def _plan(self, obs: dict, cycle: int, taken: frozenset = frozenset()) -> list[dict]:
        """The cycle's fresh actions, at most one a volume; ``taken`` holds
        the volumes a resumed action already acts on this cycle."""
        actions: list[dict] = []
        budgets = dict(self.cfg.budgets)
        planned_vids: set[int] = set(taken)

        def want(kind: str, ob: dict, detail: str = "") -> None:
            vid = ob["vid"]
            if len(actions) >= self.cfg.max_actions:
                return
            if budgets.get(kind, 0) <= 0:
                return
            if vid in planned_vids:
                return
            if self._cooldown.get(vid, 0) > cycle:
                return
            budgets[kind] -= 1
            planned_vids.add(vid)
            actions.append(
                {
                    "id": self._next_id,
                    "kind": kind,
                    "vid": vid,
                    "collection": ob["collection"],
                    "state": "planned",
                    "error": "",
                    "detail": detail,
                }
            )
            self._next_id += 1

        ordered = [obs[v] for v in sorted(obs)]
        # 1. corruption repairs outrank every tiering decision
        for ob in ordered:
            if ob["corrupt_shards"]:
                want(
                    "repair_shard",
                    ob,
                    f"shards {sorted(set().union(*map(set, ob['corrupt_shards'].values())))}",
                )
            elif ob["corrupt_needles"] and len(ob["corrupt_needles"]) < len(
                ob["replicas"]
            ):
                want(
                    "repair_replica",
                    ob,
                    f"corrupt on {sorted(ob['corrupt_needles'])}",
                )
        # 2. reclaim garbage before it rides an EC encode or a tier upload
        for ob in ordered:
            if (
                ob["kind"] == "plain"
                and not ob["tiered"]
                and ob["garbage"] >= self.cfg.garbage_threshold
            ):
                want("vacuum", ob, f"garbage {ob['garbage']:.2f}")
        # 3. hot EC volumes pay reconstruction tax on every read: un-EC
        for ob in ordered:
            if ob["kind"] == "ec" and ob["band"] == "hot":
                want("un_ec", ob, f"heat {ob['heat']:.2f}")
        # 4. tiered volumes that warmed back up come home
        for ob in ordered:
            if ob["tiered"] and ob["band"] != "cold":
                want("tier_down", ob, f"band {ob['band']}")
        # 5/6. cooling: cold → S3 tier (when configured), cool → fleet EC.
        # Both demand a streak of consecutive sub-floor observations so a
        # single quiet heartbeat can't trigger a move.
        for ob in ordered:
            streak = self._cold_streak.get(ob["vid"], 0)
            if streak < self.cfg.cold_streak or ob["size"] <= 0:
                continue
            if (
                ob["band"] == "cold"
                and self.cfg.tier_endpoint
                and not ob["tiered"]
            ):
                want("tier_up", ob, f"cold streak {streak}")
            elif (
                ob["band"] in ("cool", "cold")
                and ob["kind"] == "plain"
                and not ob["tiered"]
            ):
                want("ec", ob, f"band {ob['band']} streak {streak}")
        # 7. hot plain volumes spread load across an extra replica
        if self.cfg.hot_replicas > 0:
            for ob in ordered:
                if (
                    ob["kind"] == "plain"
                    and ob["band"] == "hot"
                    and 0 < len(ob["replicas"]) < self.cfg.hot_replicas
                ):
                    want("replica_boost", ob, f"heat {ob['heat']:.2f}")
        return actions

    def _update_streaks(self, obs: dict) -> None:
        for vid, ob in obs.items():
            if ob["band"] in ("cool", "cold"):
                self._cold_streak[vid] = self._cold_streak.get(vid, 0) + 1
            else:
                self._cold_streak[vid] = 0
        for vid in list(self._cold_streak):
            if vid not in obs:
                del self._cold_streak[vid]

    # -- the cycle ------------------------------------------------------------
    def tick(self) -> dict:
        """One synchronous observe→plan→execute cycle. Unit tests drive
        this directly with injected observe/ops/clock."""
        t0 = time.monotonic()
        with self._lock:
            self._cycle += 1
            self._counters["cycles"] += 1
            cycle = self._cycle
            paused = self._paused
        summary = {"cycle": cycle, "actions": [], "deferred": "", "locked": ""}
        if paused:
            summary["deferred"] = "paused"
            return summary
        allowed, reason = self.interlock.maintenance_allowed()
        if not allowed:
            # traffic peak: skip even the observation — heartbeats keep
            # the streak state fresh enough, and observing costs topology
            # lock acquisitions the serving path is competing for
            self._counters["cycles_deferred"] += 1
            summary["deferred"] = reason
            return summary
        obs = self._observe()
        self._update_streaks(obs)
        with self._lock:
            resume = [
                a for a in self._resume_queue if self._still_needed(a, obs)
            ]
            self._resume_queue = []
        for a in resume:
            a["state"] = "planned"
            a["detail"] = (a.get("detail") or "") + " [resumed]"
        # a resumed action holds its volume for the cycle: the JAX package
        # plans the same move afresh beside it, and runs it twice
        actions = resume + self._plan(obs, cycle, frozenset(a["vid"] for a in resume))
        if not actions:
            with self._lock:
                self._last_cycle_at = self._clock()
                self._last_cycle_seconds = time.monotonic() - t0
            return summary
        token = None
        if self._lease is not None:
            try:
                token = self._lease("lifecycle")
            except RuntimeError as e:
                # an operator's shell holds the admin lock: their cycle
                self._counters["cycles_skipped_locked"] += 1
                summary["locked"] = str(e)
                return summary
        doc = {
            "cycle": cycle,
            "state": "planned",
            "started": self._clock(),
            "actions": actions,
        }
        try:
            with CYCLE_HIST.time():
                self._persist(doc, "lifecycle.journal.planned")
                for a in actions:
                    allowed, reason = self.interlock.maintenance_allowed()
                    if not allowed:
                        a["state"] = "deferred"
                        a["error"] = reason
                        self._counters["actions_deferred"] += 1
                        continue
                    if not self._still_needed(a, obs):
                        a["state"] = "noop"
                        continue
                    a["state"] = "running"
                    self._persist(doc, "lifecycle.journal.running")
                    try:
                        with ACTION_HIST.time(kind=a["kind"]):
                            self.ops.execute(a, obs[a["vid"]])
                        a["state"] = "done"
                        self._counters["actions_done"] += 1
                        self._cooldown[a["vid"]] = (
                            cycle + self.cfg.cooldown_cycles
                        )
                        self._cold_streak[a["vid"]] = 0
                    except Exception as e:  # noqa: BLE001 - one action must not kill the cycle
                        a["state"] = "failed"
                        a["error"] = str(e)
                        self._counters["actions_failed"] += 1
                        glog.warning(
                            "lifecycle: %s volume %d failed: %s",
                            a["kind"], a["vid"], e,
                        )
                    self._persist(doc, "lifecycle.journal.done")
                doc["state"] = "done"
                self._persist(doc, "lifecycle.journal.cycle")
        finally:
            if token is not None and self._release is not None:
                self._release(token)
        with self._lock:
            self._last_actions = actions
            self._last_cycle_at = self._clock()
            self._last_cycle_seconds = time.monotonic() - t0
        summary["actions"] = actions
        return summary

    # -- daemon loop ----------------------------------------------------------
    def start(self) -> "LifecycleController":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="lifecycle-controller"
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                if self._is_leader():
                    if not self._recovered:
                        self._recover()
                    self.tick()
                else:
                    # leadership lost: force a journal replay on regain
                    self._recovered = False
            except Exception as e:  # noqa: BLE001 - the autopilot must outlive any cycle
                glog.warning("lifecycle cycle crashed: %s", e)
            self._stop.wait(self.cfg.interval)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        _unregister(self)

    # -- introspection --------------------------------------------------------
    def status(self) -> dict:
        with self._lock:
            return {
                "paused": self._paused,
                "cycle": self._cycle,
                "interval": self.cfg.interval,
                "counters": dict(self._counters),
                "recovery": dict(self.recovery),
                "last_cycle": {
                    "at": self._last_cycle_at,
                    "seconds": round(self._last_cycle_seconds, 6),
                    "actions": [dict(a) for a in self._last_actions],
                },
                "interlock": {
                    "fraction": self.interlock.fraction,
                    "blocked": bool(self.interlock.last_reason),
                    "last_reason": self.interlock.last_reason,
                },
                "tier": {
                    "enabled": bool(self.cfg.tier_endpoint),
                    "endpoint": self.cfg.tier_endpoint,
                    "bucket": self.cfg.tier_bucket,
                    "backend": self.cfg.tier_backend,
                },
                "thresholds": {
                    "heat_floor": heat_floor(),
                    "heat_ceiling": heat_ceiling(),
                    "tier_floor": tier_floor(),
                    "cold_streak": self.cfg.cold_streak,
                    "garbage": self.cfg.garbage_threshold,
                },
                "cycle_latency": CYCLE_HIST.summary(),
                "action_latency": {
                    k: ACTION_HIST.summary(kind=k)
                    for k in ACTION_KINDS
                    if ACTION_HIST.summary(kind=k).get("count")
                },
            }


# -- process-wide snapshot for the sweed_lifecycle_* gauges -------------------
# Mirrors cluster/fleet.py: metrics callbacks read a module snapshot so the
# registry never holds controllers alive past their master's stop().
_ACTIVE: list = []
_ACTIVE_LOCK = threading.Lock()


def _register(c: LifecycleController) -> None:
    with _ACTIVE_LOCK:
        _ACTIVE.append(c)


def _unregister(c: LifecycleController) -> None:
    with _ACTIVE_LOCK:
        if c in _ACTIVE:
            _ACTIVE.remove(c)


def lifecycle_stats() -> dict:
    """Aggregate controller counters across every live master in-process
    (tests run several); deployments see one controller per master."""
    with _ACTIVE_LOCK:
        active = list(_ACTIVE)
    agg = {
        "controllers": len(active),
        "paused": 0,
        "cycles": 0,
        "actions_done": 0,
        "actions_failed": 0,
        "actions_deferred": 0,
        "cycles_deferred": 0,
        "cycles_skipped_locked": 0,
        "resumed": 0,
        "abandoned": 0,
    }
    for c in active:
        st = c.status()
        if st["paused"]:
            agg["paused"] += 1
        for k in (
            "cycles",
            "actions_done",
            "actions_failed",
            "actions_deferred",
            "cycles_deferred",
            "cycles_skipped_locked",
            "resumed",
            "abandoned",
        ):
            agg[k] += st["counters"][k]
    return agg
