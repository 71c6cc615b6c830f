"""Fleet-scale EC job scheduler: the master fans encode/rebuild across
mesh-backed volume servers.

The reference drives erasure coding entirely from the shell: one operator
process walks the topology and POSTs ``/admin/ec/generate`` at one server
after another (``command_ec_encode.go``). That serializes the fleet behind a
single client and dies with it. Here the MASTER owns a small job scheduler:

* volume servers that run a device mesh report its coordinates in every
  heartbeat (``mesh`` dict: coordinator address, process_id,
  num_processes, initialized) — the scheduler's membership view is exactly
  the heartbeat-fresh topology, so a dead member stops receiving jobs the
  moment the reaper would drop it. The port's volume servers report it
  under ``SWEED_MESH=1`` (``torch.distributed``, ``VolumeServer._init_mesh``);
  without a member ``_pick_target`` falls back to the volume's holders;
* ``ec.encode -fleet`` (or any client) POSTs ``/ec/fleet/encode`` with a
  volume-id list and the scheduler fans ``/admin/ec/generate`` calls over a
  bounded worker pool — the HTTP fan-out is the control-plane analog of the
  sharded codec's ``dp`` axis (each server encodes its own volumes, the
  master only sequences);
* each generate response carries ``bytes``/``seconds`` so the scheduler
  keeps a per-member encode-GB/s ledger for ``/ec/fleet/status``.

Every encode lands on a server that already holds the volume (locality —
the job moves bytes through the codec, never across the wire) and the
staged-commit manifest inside ``Store.ec_encode_volume`` makes a mid-job
member death leave that volume either fully plain or fully EC, never torn.

Locking discipline: job-state mutation happens under the scheduler lock;
every HTTP dispatch and every topology lookup happens OUTSIDE it.

Workers start on the first ``submit``: importing the module or building a
scheduler starts no thread. Each dispatch roots a trace of its own (the
scheduler's workers run outside any request), so the member's
``/admin/ec/*`` span nests under it.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..server.http_util import http_json
from ..stats import trace as _trace
from ..stats.metrics import default_registry
from ..util import glog
from ..util.locks import make_condition, make_lock
from ..util.retry import RetryPolicy

# encode can stream many GB through the codec; rebuild pulls shards first
_JOB_TIMEOUT = 600.0

#: EC job round-trip latency (dispatch to settle), labeled by job kind
JOB_HIST = default_registry.histogram(
    "fleet_job_encode_seconds",
    "fleet EC job round-trip latency (dispatch to settle), by kind",
)


@dataclass
class EcJob:
    id: int
    kind: str  # "encode" | "rebuild"
    vid: int
    collection: str = ""
    server: str = ""  # chosen member (empty until dispatch)
    state: str = "scheduled"  # scheduled → running → done | failed
    error: str = ""
    shards: list = field(default_factory=list)
    bytes: int = 0
    seconds: float = 0.0
    created: float = field(default_factory=time.monotonic)
    # retry/preemption bookkeeping: dispatches consumed, members this job
    # must avoid (they failed or died mid-job), and a monotonic epoch that
    # fences stale settles — a worker still blocked on a dead member's HTTP
    # call must not clobber the job after preemption re-queued it elsewhere
    attempts: int = 0
    excluded: list = field(default_factory=list)
    dispatch_epoch: int = 0

    @property
    def gbps(self) -> float:
        if self.seconds <= 0:
            return 0.0
        return self.bytes / self.seconds / 1e9

    def info(self) -> dict:
        return {
            "id": self.id,
            "kind": self.kind,
            "volume": self.vid,
            "collection": self.collection,
            "server": self.server,
            "state": self.state,
            "error": self.error,
            "shards": list(self.shards),
            "bytes": self.bytes,
            "seconds": round(self.seconds, 6),
            "gbps": round(self.gbps, 4),
        }


class EcJobScheduler:
    """Bounded-worker fan-out of EC jobs over heartbeat-registered members.

    ``locate`` maps a volume id to the urls currently holding it (the
    master's in-memory topology — cheap, no HTTP). Workers are lazy: an
    idle master spawns no threads.
    """

    def __init__(
        self,
        locate: Callable[[int], list],
        workers: Optional[int] = None,
        max_attempts: Optional[int] = None,
        retry_backoff_s: float = 0.5,
    ):
        self._locate = locate
        self._lock = make_lock("EcJobScheduler._lock")
        self._jobs: dict[int, EcJob] = {}
        self._queue: "queue.Queue[int]" = queue.Queue()
        self._members: dict[str, dict] = {}  # url -> mesh dict from heartbeat
        self._member_stats: dict[str, dict] = {}
        self._threads: list[threading.Thread] = []
        self._nworkers = workers or int(
            os.environ.get("SWEED_FLEET_WORKERS", "4")
        )
        self._max_attempts = max_attempts or int(
            os.environ.get("SWEED_FLEET_MAX_ATTEMPTS", "3")
        )
        self._retry_policy = RetryPolicy(
            attempts=self._max_attempts, base_s=retry_backoff_s, cap_s=5.0
        )
        self._timers: list[threading.Timer] = []
        self._retries = 0
        self._preempted = 0
        self._stop = threading.Event()
        self._done = make_condition(self._lock)
        self._next_id = 1
        _register(self)

    # -- membership (fed by the master's heartbeat handler) -------------------
    def observe_member(self, url: str, mesh: Optional[dict]) -> None:
        with self._lock:
            if mesh is None:
                self._members.pop(url, None)
            else:
                self._members[url] = dict(mesh)

    def drop_member(self, url: str) -> None:
        """Reaper/leave hook: a dead node must stop influencing placement —
        and jobs RUNNING on it are preempted back to scheduled (attempts
        permitting) so they retry on a surviving member instead of eating
        the full dispatch timeout. The worker still blocked on the dead
        member's socket is fenced out by the dispatch epoch."""
        requeue: list[int] = []
        fail: list[tuple[int, int]] = []
        with self._lock:
            self._members.pop(url, None)
            for job in self._jobs.values():
                if job.state != "running" or job.server != url:
                    continue
                job.excluded.append(url)
                job.server = ""
                job.dispatch_epoch += 1
                self._preempted += 1
                if job.attempts >= self._max_attempts:
                    fail.append((job.id, job.dispatch_epoch))
                else:
                    job.state = "scheduled"
                    requeue.append(job.id)
        for jid in requeue:
            glog.warning("fleet: preempting job %d off dead member %s",
                         jid, url)
            self._queue.put(jid)
        for jid, epoch in fail:
            self._settle(jid, epoch=epoch,
                         error=f"{url} died; attempt cap reached")

    def members(self) -> dict[str, dict]:
        with self._lock:
            return {u: dict(m) for u, m in self._members.items()}

    # -- job intake -----------------------------------------------------------
    def submit(self, kind: str, vid: int, collection: str = "") -> int:
        if kind not in ("encode", "rebuild"):
            raise ValueError(f"unknown fleet job kind {kind!r}")
        with self._lock:
            jid = self._next_id
            self._next_id += 1
            self._jobs[jid] = EcJob(jid, kind, vid, collection)
            self._ensure_workers_locked()
        self._queue.put(jid)
        glog.V(1).info("fleet: scheduled %s volume %d as job %d", kind, vid, jid)
        return jid

    def job_info(self, jid: int) -> Optional[dict]:
        with self._lock:
            job = self._jobs.get(jid)
            return job.info() if job else None

    def wait(self, jids: list, timeout: float = _JOB_TIMEOUT) -> bool:
        """Block until every job settled (done/failed) or timeout."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                pending = [
                    j for j in jids
                    if self._jobs.get(j)
                    and self._jobs[j].state in ("scheduled", "running")
                ]
                if not pending:
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._done.wait(min(remaining, 1.0))

    # -- workers --------------------------------------------------------------
    def _ensure_workers_locked(self) -> None:
        alive = [t for t in self._threads if t.is_alive()]
        self._threads = alive
        while len(self._threads) < self._nworkers:
            t = threading.Thread(target=self._worker, daemon=True,
                                 name="fleet-ec-worker")
            self._threads.append(t)
            t.start()

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                jid = self._queue.get(timeout=0.25)
            except queue.Empty:
                continue
            try:
                self._run_job(jid)
            except Exception as e:  # noqa: BLE001 - a worker must survive
                glog.warning("fleet job %d crashed the worker: %s", jid, e)
                self._settle(jid, error=f"scheduler: {e}")

    def _pick_target(self, job: EcJob) -> Optional[str]:
        """Locality first (the volume's own holders), mesh members preferred
        among replicas — the fan-out analog of placing dp-slices on the
        processes that already hold the bytes."""
        try:
            holders = [
                (h["url"] if isinstance(h, dict) else h)
                for h in (self._locate(job.vid) or [])
            ]
        except Exception as e:  # topology lookup must not kill the job path
            glog.V(1).info("fleet: locate volume %d failed: %s", job.vid, e)
            holders = []
        excluded = set(job.excluded)
        if job.kind == "encode":
            holders = [u for u in holders if u not in excluded]
            if not holders:
                return None
            members = self.members()
            meshed = [u for u in holders if members.get(u, {}).get("initialized")]
            return (meshed or holders)[0]
        # rebuild: any live mesh member will pull what it needs; fall back
        # to the volume's own holders when nothing registered a mesh
        members = self.members()
        candidates = [u for u, m in members.items() if m.get("initialized")] \
            or list(members) or holders
        candidates = [u for u in candidates if u not in excluded]
        if not candidates:
            return None
        # spread rebuilds round-robin by job id
        return sorted(candidates)[job.id % len(candidates)]

    def _run_job(self, jid: int) -> None:
        with self._lock:
            job = self._jobs.get(jid)
            if job is None or job.state != "scheduled":
                return
            job.state = "running"
            job.attempts += 1
            epoch = job.dispatch_epoch
        target = self._pick_target(job)
        if target is None:
            self._settle(jid, epoch=epoch,
                         error=f"volume {job.vid} has no live holder")
            return
        with self._lock:
            if job.dispatch_epoch != epoch or job.state != "running":
                return  # preempted while we were choosing a target
            job.server = target
        path = "generate" if job.kind == "encode" else "rebuild"
        t0 = time.monotonic()
        try:
            with _trace.start_span(f"ec_{job.kind}", service="fleet", vid=job.vid,
                                   member=target), JOB_HIST.time(kind=job.kind):
                r = http_json(
                    "POST",
                    f"http://{target}/admin/ec/{path}?volume={job.vid}"
                    f"&collection={job.collection}",
                    timeout=_JOB_TIMEOUT,
                )
        except Exception as e:
            # transport-level failure (member died, refused, timed out):
            # retry on a DIFFERENT member with backoff, attempts permitting
            self._retry_or_fail(jid, epoch, f"{target}: {e}")
            return
        if r.get("error"):
            # the member answered: an application error (missing volume,
            # codec failure) re-breaks identically elsewhere — fail fast
            self._settle(jid, epoch=epoch, error=f"{target}: {r['error']}")
            return
        self._settle(
            jid,
            epoch=epoch,
            shards=r.get("shards") or r.get("rebuilt_shards") or [],
            nbytes=int(r.get("bytes", 0)),
            seconds=float(r.get("seconds", 0.0)) or (time.monotonic() - t0),
        )

    def _retry_or_fail(self, jid: int, epoch: int, error: str) -> None:
        with self._lock:
            job = self._jobs.get(jid)
            if job is None or job.dispatch_epoch != epoch:
                return  # preemption already re-queued (or settled) this job
            if job.attempts >= self._max_attempts:
                pass  # fall through to the terminal settle below
            else:
                if job.server:
                    job.excluded.append(job.server)
                job.server = ""
                job.state = "scheduled"
                job.dispatch_epoch += 1
                self._retries += 1
                delay = self._retry_policy.delay(job.attempts - 1)
                t = threading.Timer(delay, self._queue.put, args=(jid,))
                t.daemon = True
                self._timers.append(t)
                self._timers = [x for x in self._timers if x.is_alive()]
                glog.warning(
                    "fleet job %d attempt %d failed (%s); retrying on "
                    "another member in %.2fs", jid, job.attempts, error, delay)
                t.start()
                return
        self._settle(jid, epoch=epoch,
                     error=f"{error} (attempt cap {self._max_attempts})")

    def _settle(self, jid: int, epoch: Optional[int] = None, error: str = "",
                shards: Optional[list] = None, nbytes: int = 0,
                seconds: float = 0.0) -> None:
        with self._lock:
            job = self._jobs.get(jid)
            if job is None:
                return
            if epoch is not None and job.dispatch_epoch != epoch:
                return  # stale: the job moved on (preempted/re-queued)
            job.state = "failed" if error else "done"
            job.error = error
            job.shards = shards or []
            job.bytes = nbytes
            job.seconds = seconds
            if job.server:
                st = self._member_stats.setdefault(
                    job.server,
                    {"jobs": 0, "failed": 0, "bytes": 0, "seconds": 0.0,
                     "gbps": 0.0},
                )
                st["jobs"] += 1
                if error:
                    st["failed"] += 1
                else:
                    st["bytes"] += nbytes
                    st["seconds"] += seconds
                    st["gbps"] = round(job.gbps, 4)
            self._done.notify_all()
        if error:
            glog.warning("fleet job %d (%s volume %d) failed: %s",
                         jid, job.kind, job.vid, error)
        else:
            glog.V(1).info("fleet job %d done: %s volume %d on %s (%.2f GB/s)",
                           jid, job.kind, job.vid, job.server, job.gbps)

    # -- introspection --------------------------------------------------------
    def stats(self, jobs_tail: int = 32) -> dict:
        with self._lock:
            by_state = {"scheduled": 0, "running": 0, "done": 0, "failed": 0}
            for job in self._jobs.values():
                by_state[job.state] = by_state.get(job.state, 0) + 1
            tail = sorted(self._jobs)[-jobs_tail:]
            return {
                "members": {u: dict(m) for u, m in self._members.items()},
                "member_stats": {
                    u: dict(s) for u, s in self._member_stats.items()
                },
                "jobs_scheduled": self._next_id - 1,
                "jobs_running": by_state["running"] + by_state["scheduled"],
                "jobs_done": by_state["done"],
                "jobs_failed": by_state["failed"],
                "jobs_retried": self._retries,
                "jobs_preempted": self._preempted,
                "jobs": [self._jobs[j].info() for j in tail],
                # dispatch round-trip quantiles from fleet_job_encode_seconds
                "job_latency": {
                    "encode": JOB_HIST.summary(kind="encode"),
                    "rebuild": JOB_HIST.summary(kind="rebuild"),
                },
            }

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            threads = list(self._threads)
            timers = list(self._timers)
        for t in timers:
            t.cancel()
        for t in threads:
            t.join(timeout=2.0)
        _unregister(self)


# -- process-wide snapshot of every live scheduler ------------------------------
# The reference's /metrics gauges read this; here it is what ``fleet_stats``
# aggregates (tests run several masters in one process).
_ACTIVE: list = []
_ACTIVE_LOCK = threading.Lock()


def _register(s: EcJobScheduler) -> None:
    with _ACTIVE_LOCK:
        _ACTIVE.append(s)


def _unregister(s: EcJobScheduler) -> None:
    with _ACTIVE_LOCK:
        if s in _ACTIVE:
            _ACTIVE.remove(s)


def fleet_stats() -> dict:
    """Aggregate scheduler counters across every live master in-process
    (tests run several); single-daemon deployments see one scheduler."""
    with _ACTIVE_LOCK:
        active = list(_ACTIVE)
    agg = {"schedulers": len(active), "members": 0, "jobs_scheduled": 0,
           "jobs_running": 0, "jobs_done": 0, "jobs_failed": 0,
           "jobs_retried": 0, "jobs_preempted": 0, "member_gbps": {}}
    for s in active:
        st = s.stats(jobs_tail=0)
        agg["members"] += len(st["members"])
        for k in ("jobs_scheduled", "jobs_running", "jobs_done", "jobs_failed",
                  "jobs_retried", "jobs_preempted"):
            agg[k] += st[k]
        for u, ms in st["member_stats"].items():
            agg["member_gbps"][u] = ms.get("gbps", 0.0)
    return agg
