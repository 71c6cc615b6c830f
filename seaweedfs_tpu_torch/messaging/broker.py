"""Message broker daemon: the port's copy of the JAX package's
``messaging/broker.py`` (reference `messaging/broker/broker_server.go` +
`topic_manager.go`): per-(topic,partition) log buffers, segments persisted
as filer files `/topics/<ns>/<topic>/<pp>/<start_ts:020d>.seg`, subscribe
replays persisted segments then tails memory
(`broker_grpc_server_subscribe.go:18,137`).
"""

from __future__ import annotations

import base64
import threading
from typing import Optional

from ..filer.client import FilerClient
from ..server.http_util import JsonHandler, start_server
from ..util.parsers import tolerant_uint
from .log_buffer import LogBuffer, decode_messages
from ..util.locks import make_lock

TOPICS_ROOT = "/topics"


class TopicPartition:
    def __init__(self, client: FilerClient, ns: str, topic: str, partition: int):
        self.client = client
        self.dir = f"{TOPICS_ROOT}/{ns}/{topic}/{partition:02d}"
        self.buffer = LogBuffer(
            flush_fn=self._flush_segment,
            flush_bytes=1 * 1024 * 1024,
            flush_interval=1.0,
        )

    def _flush_segment(self, start_ts: int, stop_ts: int, blob: bytes) -> None:
        # segment name = zero-padded start ts → names sort chronologically
        self.client.put_object(f"{self.dir}/{start_ts:020d}.seg", blob)

    def publish(self, key: bytes, value: bytes) -> int:
        return self.buffer.append(key, value)

    def read(self, since_ns: int, limit: int = 1000):
        """Persisted segments for history, memory for the tail; strictly
        increasing ts guarantees the overlap dedupes itself."""
        out = []
        floor = self.buffer.memory_floor_ts()
        if since_ns + 1 < floor or floor == 0:
            segs = [
                e["name"]
                for e in self.client.list(self.dir, limit=100000)
                if e["name"].endswith(".seg")
            ]
            segs.sort()
            # a segment may span since_ns, so include the newest one starting
            # at or before it, plus everything after
            keep, last_before = [], None
            for name in segs:
                if int(name.split(".")[0]) > since_ns:
                    keep.append(name)
                else:
                    last_before = name
            if last_before is not None:
                keep.insert(0, last_before)
            for name in keep:
                status, blob, _ = self.client.get_object(f"{self.dir}/{name}")
                if status != 200:
                    continue
                for ts, k, v in decode_messages(blob):
                    if ts > since_ns and (floor == 0 or ts < floor):
                        out.append((ts, k, v))
                        if len(out) >= limit:
                            return out
        last = out[-1][0] if out else since_ns
        out.extend(self.buffer.read_since(last, limit - len(out)))
        return out[:limit]

    def close(self):
        self.buffer.close()

    def discard(self):
        """Drop pending data without persisting (topic deletion)."""
        self.buffer.discard()


class TopicManager:
    def __init__(self, filer_url: str):
        self.client = FilerClient(filer_url)
        self._partitions: dict[tuple, TopicPartition] = {}
        self._dead: set[tuple[str, str]] = set()  # tombstones until recreate
        self._lock = make_lock("TopicManager._lock")

    def conf_path(self, ns: str, topic: str) -> str:
        return f"{TOPICS_ROOT}/{ns}/{topic}/.conf"

    def create_topic(self, ns: str, topic: str, partitions: int = 4) -> dict:
        with self._lock:
            self._dead.discard((ns, topic))  # explicit recreate revives it
        conf = {"extended": {"partitions": str(partitions)}}
        self.client.create_entry(self.conf_path(ns, topic), conf)
        return {"namespace": ns, "topic": topic, "partitions": partitions}

    def topic_conf(self, ns: str, topic: str) -> Optional[dict]:
        e = self.client.get_entry(self.conf_path(ns, topic))
        if e is None:
            return None
        return {
            "namespace": ns,
            "topic": topic,
            "partitions": int(e.get("extended", {}).get("partitions", 1)),
        }

    def delete_topic(self, ns: str, topic: str) -> dict:
        """DeleteTopic rpc analog (messaging.proto): evict live partitions
        (discarding un-flushed data and JOINING in-flight flush threads — a
        late flush would resurrect the tree as orphan segments), tombstone
        the topic so concurrent publishes can't recreate a partition, then
        drop the log tree + conf from the filer. Filer I/O happens OUTSIDE
        the lock so a slow delete never stalls other topics' pub/sub."""
        with self._lock:
            self._dead.add((ns, topic))
            doomed = [
                self._partitions.pop(k)
                for k in [k for k in self._partitions
                          if k[0] == ns and k[1] == topic]
            ]
        for tp in doomed:
            tp.discard()
        self.client.delete(f"{TOPICS_ROOT}/{ns}/{topic}", recursive=True)
        return {"namespace": ns, "topic": topic, "deleted": True}

    def get_partition(self, ns: str, topic: str, partition: int) -> TopicPartition:
        key = (ns, topic, partition)
        with self._lock:
            tp = self._partitions.get(key)
            if tp is not None:
                return tp
            if (ns, topic) in self._dead:
                raise KeyError(f"no such topic {ns}/{topic}")
        # conf lookup = filer HTTP; never hold the global lock across it
        if self.topic_conf(ns, topic) is None:
            raise KeyError(f"no such topic {ns}/{topic}")
        with self._lock:
            tp = self._partitions.get(key)
            if tp is None:
                if (ns, topic) in self._dead:  # deleted while we looked
                    raise KeyError(f"no such topic {ns}/{topic}")
                tp = TopicPartition(self.client, ns, topic, partition)
                self._partitions[key] = tp
        return tp

    def close(self):
        with self._lock:
            for tp in self._partitions.values():
                tp.close()


class Broker:
    """HTTP pub/sub daemon. The reference speaks gRPC streams
    (`messaging_pb.SeaweedMessaging`, 6 rpcs); the poll-based HTTP surface
    here carries the same operations."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 17777,
        filer_url: str = "127.0.0.1:8888",
    ):
        self.host, self.port = host, port
        self.topics = TopicManager(filer_url)
        self._srv = None

    # /pub/<ns>/<topic>/<partition>
    def _h_pub(self, h, path, q, body):
        _, _, ns, topic, part = path.split("/", 4)
        try:
            tp = self.topics.get_partition(ns, topic, int(part))
        except KeyError as e:
            return 404, {"error": str(e)}
        key = base64.b64decode(h.headers.get("X-Msg-Key", "") or "")
        ts = tp.publish(key, body)
        if ts == 0:
            # the message was dropped, and acking it as 200 would lie to
            # the producer about durability. 410 only for a real deletion;
            # a broker mid-shutdown is retryable → 503
            if tp.buffer.discarded:
                return 410, {"error": f"topic {ns}/{topic} deleted"}
            return 503, {"error": "broker shutting down, retry"}
        return 200, {"ts_ns": ts}

    # /sub/<ns>/<topic>/<partition>?since_ns=&limit=
    def _h_sub(self, h, path, q, body):
        _, _, ns, topic, part = path.split("/", 4)
        try:
            tp = self.topics.get_partition(ns, topic, int(part))
        except KeyError as e:
            return 404, {"error": str(e)}
        # tolerant: a subscriber's garbage ?since_ns= must not 500 the broker
        msgs = tp.read(
            tolerant_uint(q.get("since_ns", 0), 0),
            tolerant_uint(q.get("limit", 1000), 1000),
        )
        out = [
            {
                "ts_ns": ts,
                "key": base64.b64encode(k).decode(),
                "value": base64.b64encode(v).decode(),
            }
            for ts, k, v in msgs
        ]
        return 200, {
            "messages": out,
            "last_ts_ns": out[-1]["ts_ns"]
            if out
            else tolerant_uint(q.get("since_ns", 0), 0),
        }

    # /topics/<ns>/<topic>
    def _h_topics(self, h, path, q, body):
        parts = path.split("/")
        if len(parts) < 4:
            return 400, {"error": "need /topics/<ns>/<topic>"}
        ns, topic = parts[2], parts[3]
        if h.command == "POST":
            if q.get("op") == "delete":
                return 200, self.topics.delete_topic(ns, topic)
            return 200, self.topics.create_topic(
                ns, topic, tolerant_uint(q.get("partitions", 4), 4)
            )
        conf = self.topics.topic_conf(ns, topic)
        if conf is None:
            return 404, {"error": "no such topic"}
        return 200, conf

    def _h_flush(self, h, path, q, body):
        for tp in list(self.topics._partitions.values()):
            tp.buffer.flush()
        return 200, {"ok": True}

    def start(self):
        broker = self

        class Handler(JsonHandler):
            routes = [
                ("POST", "/pub/", broker._h_pub),
                ("GET", "/sub/", broker._h_sub),
                ("POST", "/topics/", broker._h_topics),
                ("GET", "/topics/", broker._h_topics),
                ("POST", "/_flush", broker._h_flush),
            ]

        self._srv = start_server(Handler, self.host, self.port)
        return self

    def stop(self):
        self.topics.close()
        if self._srv:
            self._srv.shutdown()
            self._srv.server_close()

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"
