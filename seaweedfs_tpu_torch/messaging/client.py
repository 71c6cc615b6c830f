"""Messaging client library: the port's copy of the JAX package's
``messaging/client.py`` (reference `messaging/msgclient/`): publisher with
consistent-hash partition→broker routing, poll-based subscriber, and the
channel layer (`chan_pub.go:15` PubChannel / `chan_sub.go:16` SubChannel) —
named one-partition streams under the reserved "chan" namespace with md5
integrity accumulators and an in-band close marker.
"""

from __future__ import annotations

import base64
import hashlib
import time
from typing import Iterator, Optional

from ..server.http_util import http_bytes, http_json
from .consistent import ConsistentRing
from .consistent import _hash as _ring_hash

def partition_for_key(key: bytes, partitions: int) -> int:
    """Stable key→partition routing, NOT Python hash(): per-key ordering
    only holds if every producer process (and every restart — hash(bytes)
    is salted per-interpreter via PYTHONHASHSEED) routes the same key to
    the same partition. Shares the ring's digest (consistent._hash)."""
    return _ring_hash(key) % partitions


# the reference marks end-of-channel with Message.IsClose (chan_pub.go:55);
# this wire carries key+value, so a reserved key is the close marker — keys
# beginning with NUL are not constructible through the channel Publish API
_CHAN_NS = "chan"
_CLOSE_KEY = b"\x00chan.close"


class MessagingClient:
    def __init__(self, brokers: list[str]):
        self.brokers = brokers
        self.ring = ConsistentRing()
        for b in brokers:
            self.ring.add(b)

    def _broker_for(self, ns: str, topic: str, partition: int) -> str:
        return self.ring.get(f"{ns}/{topic}/{partition:02d}")

    # -- topic admin ---------------------------------------------------------
    def create_topic(self, ns: str, topic: str, partitions: int = 4) -> dict:
        # every broker: creation clears any delete-tombstone a broker holds
        # for this topic (deletes fan out the same way)
        out = {}
        for b in self.brokers:
            out = http_json(
                "POST",
                f"http://{b}/topics/{ns}/{topic}?partitions={partitions}",
            )
        return out

    def topic_conf(self, ns: str, topic: str) -> dict:
        return http_json("GET", f"http://{self.brokers[0]}/topics/{ns}/{topic}")

    def delete_topic(self, ns: str, topic: str) -> dict:
        """DeleteTopic (messaging.proto): drop log tree + conf everywhere —
        every broker may hold live partitions of it."""
        out = {}
        for b in self.brokers:
            out = http_json(
                "POST", f"http://{b}/topics/{ns}/{topic}?op=delete"
            )
        return out

    # -- publish -------------------------------------------------------------
    def publish(
        self,
        ns: str,
        topic: str,
        value: bytes,
        key: bytes = b"",
        partition: Optional[int] = None,
    ) -> int:
        if partition is None:
            conf = self.topic_conf(ns, topic)
            n = conf.get("partitions", 1)
            partition = (
                partition_for_key(key, n) if key
                else time.monotonic_ns() % n
            )
        broker = self._broker_for(ns, topic, partition)
        import urllib.request

        req = urllib.request.Request(
            f"http://{broker}/pub/{ns}/{topic}/{partition}",
            data=value,
            method="POST",
        )
        if key:
            req.add_header("X-Msg-Key", base64.b64encode(key).decode())
        # sweedlint: ok deadline-not-propagated broker pub is fire-and-forget from producers, not a fan of an inbound request; its own timeout bounds it
        with urllib.request.urlopen(req, timeout=30) as resp:
            import json

            return json.loads(resp.read())["ts_ns"]

    # -- subscribe -----------------------------------------------------------
    def fetch(
        self, ns: str, topic: str, partition: int, since_ns: int = 0,
        limit: int = 1000,
    ) -> tuple[list[dict], int]:
        broker = self._broker_for(ns, topic, partition)
        status, body = http_bytes(
            "GET",
            f"http://{broker}/sub/{ns}/{topic}/{partition}"
            f"?since_ns={since_ns}&limit={limit}",
        )
        import json

        d = json.loads(body)
        msgs = [
            {
                "ts_ns": m["ts_ns"],
                "key": base64.b64decode(m["key"]),
                "value": base64.b64decode(m["value"]),
            }
            for m in d.get("messages", [])
        ]
        return msgs, d.get("last_ts_ns", since_ns)

    # -- channels (msgclient/chan_pub.go, chan_sub.go) -----------------------
    def new_pub_channel(self, chan_name: str) -> "PubChannel":
        """NewPubChannel (chan_pub.go:21): a named single-partition stream
        under the reserved "chan" namespace."""
        self.create_topic(_CHAN_NS, chan_name, partitions=1)
        return PubChannel(self, chan_name)

    def new_sub_channel(self, subscriber_id: str, chan_name: str) -> "SubChannel":
        """NewSubChannel (chan_sub.go:23). `subscriber_id` names the
        consumer for diagnostics (the poll transport needs no server-side
        registration)."""
        self.create_topic(_CHAN_NS, chan_name, partitions=1)
        return SubChannel(self, subscriber_id, chan_name)

    def subscribe(
        self,
        ns: str,
        topic: str,
        partition: int,
        since_ns: int = 0,
        poll_interval: float = 0.1,
        stop_after_idle: Optional[float] = None,
    ) -> Iterator[dict]:
        """Replay from since_ns then tail. Yields message dicts; stops after
        `stop_after_idle` seconds without new messages (None = forever)."""
        offset = since_ns
        idle_since = time.monotonic()
        while True:
            msgs, offset = self.fetch(ns, topic, partition, offset)
            if msgs:
                idle_since = time.monotonic()
                yield from msgs
            else:
                if (
                    stop_after_idle is not None
                    and time.monotonic() - idle_since > stop_after_idle
                ):
                    return
                time.sleep(poll_interval)


class PubChannel:
    """Write side of a named channel (chan_pub.go:15): every Publish lands
    on partition 0 of chan/<name>, an md5 accumulates over published bytes
    (the reference's transfer-integrity check), and close() sends the
    in-band close marker that ends the far side's iteration."""

    def __init__(self, mc: MessagingClient, name: str):
        self._mc = mc
        self.name = name
        self._md5 = hashlib.md5()
        self._closed = False

    def publish(self, value: bytes) -> int:
        if self._closed:
            raise ValueError(f"channel {self.name} is closed")
        ts = self._mc.publish(_CHAN_NS, self.name, value, partition=0)
        self._md5.update(value)
        return ts

    def close(self) -> None:
        if not self._closed:
            # only latch closed once the marker is durably published — a
            # failed close() must stay retryable or subscribers hang forever
            self._mc.publish(
                _CHAN_NS, self.name, b"", key=_CLOSE_KEY, partition=0
            )
            self._closed = True

    def md5(self) -> bytes:
        return self._md5.digest()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SubChannel:
    """Read side (chan_sub.go:16): iterates values from the beginning of
    the channel, ends cleanly at the close marker, and accumulates the
    same md5 so both ends can compare digests after the stream."""

    def __init__(self, mc: MessagingClient, subscriber_id: str, name: str):
        self._mc = mc
        self.subscriber_id = subscriber_id
        self.name = name
        self._md5 = hashlib.md5()

    def __iter__(self) -> Iterator[bytes]:
        for m in self._mc.subscribe(_CHAN_NS, self.name, 0, since_ns=0):
            if m["key"] == _CLOSE_KEY:
                return
            self._md5.update(m["value"])
            yield m["value"]

    def md5(self) -> bytes:
        return self._md5.digest()
