"""Master leader election: majority-vote terms + quorum-gated leadership.

Reference: `weed/server/raft_server.go:21-54` — the reference embeds a raft
group among masters whose replicated state machine holds ONLY the sequence
counter (max file key); topology is rebuilt from volume-server heartbeats,
and non-leader masters proxy client traffic to the leader
(`master_server.go` proxyToLeader).

The JAX package implements the same safety contract with a compact
raft-shaped protocol over the masters' HTTP plane (no external
coordination service, matching the reference's embedded consensus), and
this is its port: the two packages' masters vote and beat with each other,
and each reads the other's state file (``{"term", "voted_for"}``):

- **terms + one vote per term**: a candidate claims leadership only after
  collecting votes from a MAJORITY of the configured peer set; two leaders
  in one term are impossible, and two sides of a partition cannot both
  reach majority.
- **quorum-gated leading**: the leader counts beat acks every round and
  steps down (stops serving assigns) when it cannot reach a majority for a
  full lease — an isolated ex-leader goes silent instead of split-braining.
- **pre-vote phase**: a candidate first asks peers whether they WOULD vote
  (no state change on either side) and only bumps its real term after a
  pre-vote majority — so a flapping node never inflates the cluster term
  and cannot depose a healthy leader on heal (raft's pre-vote extension).
- **persisted term/vote**: with a `state_path`, (term, voted_for) survive
  restarts, so a bounced master cannot vote twice in one term (raft's
  durable currentTerm/votedFor). Without a state_path the startup lease
  grace makes double-voting unlikely but not impossible — pass a path in
  production.
- **state checkpoint riding beats**: each beat carries the sequence
  high-water mark AND the max volume id; followers checkpoint both, so a
  failover never re-issues needle ids or volume ids (the raft
  snapshot-of-sequence analog, plus the volume-id replication the
  reference gets from `Topology.NextVolumeId` going through raft).
- **up-to-date check**: a vote is denied to a candidate whose sequence
  checkpoint is behind the voter's, so a restarted master with a cold
  sequencer cannot win until it has caught up from beats.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Optional

from ..server.http_util import http_json
from ..util import glog
from ..util.locks import make_lock


class LeaderElection:
    def __init__(
        self,
        self_url: str,
        peers: list[str],
        lease_seconds: float = 3.0,
        get_max_file_key: Optional[Callable[[], int]] = None,
        on_checkpoint: Optional[Callable[[int], None]] = None,
        on_leader_change: Optional[Callable[[str], None]] = None,
        get_max_volume_id: Optional[Callable[[], int]] = None,
        on_volume_id_checkpoint: Optional[Callable[[int], None]] = None,
        state_path: Optional[str] = None,
    ):
        self.self_url = self_url
        # peer set always includes self, deduplicated, stable order
        self.peers = sorted(set(peers) | {self_url})
        self.lease_seconds = lease_seconds
        self.get_max_file_key = get_max_file_key or (lambda: 0)
        self.on_checkpoint = on_checkpoint or (lambda k: None)
        self.on_leader_change = on_leader_change or (lambda u: None)
        self.get_max_volume_id = get_max_volume_id or (lambda: 0)
        self.on_volume_id_checkpoint = on_volume_id_checkpoint or (lambda v: None)

        self.state_path = state_path
        self.term = 0
        self.voted_for: Optional[str] = None  # vote cast in self.term
        self.leader: Optional[str] = None
        if state_path and os.path.exists(state_path):
            try:
                with open(state_path) as f:
                    st = json.load(f)
                self.term = int(st.get("term", 0))
                self.voted_for = st.get("voted_for") or None
            except Exception:
                glog.warning("unreadable election state %s; starting cold",
                             state_path)
        # grace: a freshly (re)started master must listen for one full lease
        # before campaigning, or a restarted ex-leader with a cold sequencer
        # would disrupt the incumbent
        self._last_beat = time.time()
        self._last_quorum = 0.0  # leader side: last majority contact
        self._lock = make_lock("LeaderElection._lock")
        # Durable-state writer: serializes the (term, voted_for) disk
        # writes OUTSIDE self._lock so an fsync never blocks vote/beat
        # intake.  Never nested inside self._lock.
        self._persist_lock = make_lock("LeaderElection._persist_lock")
        self._persist_seq = 0  # bumped under self._lock at each snapshot
        self._persisted_seq = 0  # highest seq on disk; under _persist_lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def quorum(self) -> int:
        return len(self.peers) // 2 + 1

    @property
    def is_leader(self) -> bool:
        """True only while leadership is quorum-backed: an isolated leader
        whose beats stopped reaching a majority reports False (and the
        master refuses assigns) even before it formally steps down."""
        # sweedlint: ok lock-discipline lock-free probe; a stale read flips on the next beat round
        if self.leader != self.self_url:
            return False
        if len(self.peers) == 1:
            return True
        # sweedlint: ok lock-discipline staleness is exactly what the lease check bounds
        return (time.time() - self._last_quorum) < self.lease_seconds

    # -- vote intake ---------------------------------------------------------
    def _snapshot_locked(self) -> tuple[int, int, Optional[str]]:
        """Capture (seq, term, voted_for) for a durable write.  Called with
        self._lock held; the disk write happens later, in
        ``_persist_snapshot``, after the lock is released."""
        self._persist_seq += 1
        return (self._persist_seq, self.term, self.voted_for)

    def _persist_snapshot(
        self, snap: Optional[tuple[int, int, Optional[str]]]
    ) -> None:
        """Durable (term, voted_for) — must hit disk before the reply or
        request that references it leaves, or a restart could double-vote
        (raft's currentTerm/votedFor persistence).  Runs OUTSIDE
        self._lock so the fsync never stalls vote/beat intake; the
        sequence number makes concurrent writers safe — a slow older
        write is skipped rather than clobbering a newer one."""
        if snap is None or not self.state_path:
            return
        seq, term, voted_for = snap
        with self._persist_lock:
            if seq <= self._persisted_seq:
                return  # a newer snapshot already reached disk
            tmp = self.state_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"term": term, "voted_for": voted_for}, f)
                f.flush()
                # sweedlint: ok blocking-under-lock dedicated IO lock held only around this write, never nested in _lock
                os.fsync(f.fileno())
            os.replace(tmp, self.state_path)
            self._persisted_seq = seq

    def _up_to_date(self, max_file_key: int, max_volume_id: int) -> bool:
        """Candidate state must not be behind the voter's: a cold-restarted
        master with a stale sequence or volume-id counter cannot win."""
        return (
            max_file_key >= self.get_max_file_key()
            and max_volume_id >= self.get_max_volume_id()
        )

    def receive_vote_request(
        self,
        candidate: str,
        term: int,
        max_file_key: int,
        max_volume_id: int = 0,
        prevote: bool = False,
    ) -> dict:
        # The finally-persist runs after the lock is released and before
        # the return value actually leaves, so every reply that reflects
        # a term/vote mutation is durable first — without holding other
        # vote/beat intake hostage to the fsync.
        snap = None
        try:
            with self._lock:
                lease_fresh = (time.time() - self._last_beat) < self.lease_seconds
                disruptive = (
                    lease_fresh
                    and self.leader is not None
                    and self.leader != candidate
                )
                if prevote:
                    # answer only — NO state change on either side: the
                    # candidate bumps its real term only after a pre-vote
                    # majority, so a flapping node can't inflate cluster terms
                    granted = (
                        term > self.term
                        and not disruptive
                        and self._up_to_date(max_file_key, max_volume_id)
                    )
                    return {"granted": granted, "term": self.term}
                if term < self.term:
                    return {"granted": False, "term": self.term}
                if disruptive:
                    # deny without adopting the term: a live leader's followers
                    # don't let an out-of-band campaigner move the term forward
                    return {"granted": False, "term": self.term}
                if term > self.term:
                    stepping_down = self.leader == self.self_url
                    self.term = term
                    self.voted_for = None
                    self.leader = None
                    snap = self._snapshot_locked()
                    if stepping_down:
                        glog.info("%s: saw term %d, stepping down", self.self_url, term)
                if self.voted_for not in (None, candidate):
                    return {"granted": False, "term": self.term}
                if not self._up_to_date(max_file_key, max_volume_id):
                    return {"granted": False, "term": self.term}
                if self.voted_for != candidate:
                    self.voted_for = candidate
                    snap = self._snapshot_locked()
                self._last_beat = time.time()  # defer our own candidacy
                return {"granted": True, "term": self.term}
        finally:
            self._persist_snapshot(snap)

    # -- beat intake (follower side) -----------------------------------------
    def receive_beat(
        self,
        leader: str,
        term: int,
        max_file_key: int,
        max_volume_id: int = 0,
    ) -> dict:
        snap = None
        with self._lock:
            if term < self.term:
                return {"ok": False, "term": self.term}
            if term == self.term and self.leader not in (None, leader):
                # cannot happen with vote safety; guard anyway
                return {"ok": False, "term": self.term}
            changed = leader != self.leader
            term_changed = term != self.term
            self.term = term
            if term_changed:
                self.voted_for = None
            self.leader = leader
            self._last_beat = time.time()
            if term_changed:
                snap = self._snapshot_locked()
        self._persist_snapshot(snap)
        if max_file_key:
            self.on_checkpoint(max_file_key)
        if max_volume_id:
            self.on_volume_id_checkpoint(max_volume_id)
        if changed:
            self.on_leader_change(leader)
        return {"ok": True, "term": term}

    # -- the election loop ---------------------------------------------------
    def start(self) -> "LeaderElection":
        if len(self.peers) == 1:
            # single master: it IS the cluster — lead immediately, no loop
            # latency (the reference's one-node raft elects itself at boot)
            with self._lock:
                self.term = 1
                self.leader = self.self_url
                self._last_beat = time.time()
            self.on_leader_change(self.self_url)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)

    def _rpc(self, peer: str, path: str, body: dict) -> dict:
        """Send one control-plane message to a peer master. Overridable in
        tests to simulate partitions without sockets."""
        return http_json("POST", f"http://{peer}{path}", body, timeout=1.0)

    def _send_beats(self) -> int:
        """One beat round. Returns ack count including self; steps down
        inline when a peer reports a higher term."""
        body = {
            "leader": self.self_url,
            # sweedlint: ok lock-discipline stale term in a beat is rejected by peers and triggers step-down
            "term": self.term,
            "max_file_key": self.get_max_file_key(),
            "max_volume_id": self.get_max_volume_id(),
        }
        acks = 1  # self
        for p in self.peers:
            if p == self.self_url:
                continue
            try:
                r = self._rpc(p, "/cluster/leader_beat", body)
            except Exception as e:
                glog.V(2).info("leader_beat to %s failed: %s", p, e)
                continue
            if r.get("ok"):
                acks += 1
            # sweedlint: ok lock-discipline optimistic check; re-validated under the lock below
            elif r.get("term", 0) > self.term:
                snap = None
                with self._lock:
                    if r["term"] > self.term:
                        self.term = r["term"]
                        self.leader = None
                        self.voted_for = None
                        snap = self._snapshot_locked()
                self._persist_snapshot(snap)
                glog.info("%s: peer %s has term %d, stepping down",
                          self.self_url, p, r["term"])
                return 0
        return acks

    def _collect_votes(self, term: int, prevote: bool) -> Optional[int]:
        """One vote round; None means a higher term was seen (abort)."""
        body = {
            "candidate": self.self_url,
            "term": term,
            "max_file_key": self.get_max_file_key(),
            "max_volume_id": self.get_max_volume_id(),
            "prevote": prevote,
        }
        votes = 1  # self
        for p in self.peers:
            if p == self.self_url:
                continue
            try:
                r = self._rpc(p, "/cluster/vote", body)
            except Exception as e:
                glog.V(2).info("vote rpc to %s failed: %s", p, e)
                continue
            if r.get("granted"):
                votes += 1
            elif r.get("term", 0) > term:
                # adopt the observed (already-existing) cluster term so a
                # lagging candidate catches up and can campaign next round
                snap = None
                with self._lock:
                    if r["term"] > self.term:
                        self.term = r["term"]
                        self.voted_for = None
                        snap = self._snapshot_locked()
                self._persist_snapshot(snap)
                return None
        return votes

    def _campaign(self) -> None:
        """Pre-vote then real vote for term+1; lead only on a
        configured-set majority."""
        # sweedlint: ok lock-discipline optimistic; re-validated under the lock before adopting
        proposed = self.term + 1
        pre = self._collect_votes(proposed, prevote=True)
        if pre is None or pre < self.quorum:
            glog.V(1).info("%s: pre-vote for term %d got %s/%d",
                           self.self_url, proposed, pre, self.quorum)
            return
        with self._lock:
            if self.term >= proposed:  # someone moved on meanwhile
                return
            self.term = proposed
            term = self.term
            self.voted_for = self.self_url
            snap = self._snapshot_locked()
        # durable before the first vote request leaves: a crash between
        # voting for self and soliciting peers must not forget the term
        self._persist_snapshot(snap)
        votes = self._collect_votes(term, prevote=False)
        if votes is None:
            return
        if votes < self.quorum:
            glog.V(1).info("%s: term %d campaign got %d/%d votes",
                           self.self_url, term, votes, self.quorum)
            return
        with self._lock:
            if self.term != term:  # someone moved on mid-campaign
                return
            self.leader = self.self_url
            self._last_beat = time.time()
            self._last_quorum = time.time()
        glog.info("%s: elected leader for term %d (%d/%d votes)",
                  self.self_url, term, votes, len(self.peers))
        self.on_leader_change(self.self_url)
        self._send_beats()

    def _rank(self) -> int:
        """Position of self among peers — staggers candidacy so the
        smallest url campaigns first and vote splits are rare (the
        deterministic stand-in for raft's randomized timeouts)."""
        return self.peers.index(self.self_url)

    def _loop(self) -> None:
        interval = self.lease_seconds / 3.0
        while not self._stop.wait(interval):
            with self._lock:
                leading = self.leader == self.self_url
            if leading:
                acks = self._send_beats()
                now = time.time()
                if acks >= self.quorum:
                    with self._lock:
                        self._last_quorum = now
                        self._last_beat = now
                # sweedlint: ok lock-discipline only this thread writes _last_quorum between beats
                elif now - self._last_quorum > self.lease_seconds:
                    with self._lock:
                        if self.leader == self.self_url:
                            self.leader = None
                    glog.info("%s: lost quorum, stepping down", self.self_url)
                continue
            with self._lock:
                expired_for = (time.time() - self._last_beat) - self.lease_seconds
            # stagger candidacy by rank to avoid split votes
            if expired_for < self._rank() * interval:
                continue
            self._campaign()
