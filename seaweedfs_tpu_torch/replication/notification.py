"""Notification bus: publish filer meta events to pluggable queues — the
port's copy of the JAX package's ``replication/notification.py``.

Reference: `weed/notification/configuration.go` (`Queues` registry) with
kafka / aws_sqs / google_pub_sub / log backends. Here:

- MemoryQueue / FileQueue: in-process + durable JSONL hand-off
- LogQueue: log emitter (`notification/log/log_queue.go`)
- WebhookQueue: HTTP POST per event to any collector
- SqsQueue: native SigV4-signed SendMessage over plain HTTP — no SDK
  (`notification/aws_sqs/aws_sqs_pub.go`)
- KafkaQueue / PubSubQueue: gated on their optional client libraries
  (kafka wire protocol and GCP OAuth are SDK territory)

A FileQueue line is the JAX package's record (``{"key", "message"}``), so
either package's consumer reads the other's file.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import queue
import threading
import urllib.error
import urllib.parse
import urllib.request
from datetime import datetime, timezone
from typing import Optional

from ..util import faultpoints, glog


class MessageQueue:
    def send(self, key: str, message: dict) -> None:
        raise NotImplementedError


class MemoryQueue(MessageQueue):
    """In-process hand-off. Overflow drops the OLDEST entry (counted in
    ``dropped``) rather than blocking the sender — the bus calls ``send``
    from its drain thread, and a full queue must never wedge it behind a
    consumer that went away."""

    def __init__(self, maxsize: int = 10000):
        self.q: queue.Queue = queue.Queue(maxsize=maxsize)
        self.dropped = 0

    def send(self, key, message):
        while True:
            try:
                self.q.put_nowait((key, message))
                return
            except queue.Full:
                try:
                    self.q.get_nowait()
                    self.dropped += 1
                except queue.Empty:
                    pass  # racing consumer freed space; retry the put

    def receive(self, timeout: float = 1.0) -> Optional[tuple[str, dict]]:
        try:
            return self.q.get(timeout=timeout)
        except queue.Empty:
            return None


class FileQueue(MessageQueue):
    """Append-only JSONL event log, crash-durable: each append is flushed
    and fsynced before ``send`` returns, and ``read_all`` tolerates a torn
    trailing line (a kill mid-append leaves a partial record; it is the
    only line allowed to be garbage, counted in ``torn_lines``)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self.torn_lines = 0

    def send(self, key, message):
        line = json.dumps({"key": key, "message": message})
        with self._lock, open(self.path, "a") as f:
            f.write(line + "\n")
            f.flush()
            # torn-write faults truncate mid-record here, modeling power
            # loss between the buffered append and its fsync
            faultpoints.fire("notify.file.append", path=self.path)
            os.fsync(f.fileno())

    def read_all(self) -> list[dict]:
        try:
            with open(self.path) as f:
                raw = [ln for ln in f if ln.strip()]
        except FileNotFoundError:
            return []
        out: list[dict] = []
        for i, ln in enumerate(raw):
            try:
                out.append(json.loads(ln))
            except json.JSONDecodeError:
                if i == len(raw) - 1:
                    self.torn_lines += 1
                    glog.warning(
                        "%s: skipping torn trailing line (%d bytes)",
                        self.path, len(ln),
                    )
                else:
                    raise  # mid-file corruption is NOT a crash artifact
        return out


class LogQueue(MessageQueue):
    """Events to the leveled log (`notification/log/log_queue.go`)."""

    def send(self, key, message):
        glog.info("notification %s: %s", key, json.dumps(message))


class WebhookQueue(MessageQueue):
    """POST each event as JSON to a collector URL. Delivery is best-effort
    (the bus must not stall filer mutations); failures are logged."""

    def __init__(self, url: str, timeout: float = 5.0):
        self.url = url
        self.timeout = timeout

    def send(self, key, message):
        body = json.dumps({"key": key, "message": message}).encode()
        req = urllib.request.Request(
            self.url,
            data=body,
            method="POST",
            headers={"Content-Type": "application/json"},
        )
        try:
            # sweedlint: ok deadline-not-propagated webhook egress leaves the cluster; the internal deadline header must not leak
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                if resp.status >= 300:
                    glog.warning("webhook %s → %d", self.url, resp.status)
        except (urllib.error.URLError, OSError) as e:
            glog.warning("webhook %s failed: %s", self.url, e)


class SqsQueue(MessageQueue):
    """AWS SQS SendMessage with native SigV4 signing — stdlib only
    (`notification/aws_sqs/aws_sqs_pub.go` minus the SDK).

    `queue_url` like https://sqs.us-east-1.amazonaws.com/1234/events;
    `endpoint` override points at localstack/fakes in tests.
    """

    def __init__(
        self,
        queue_url: str,
        access_key: str,
        secret_key: str,
        region: str = "us-east-1",
        endpoint: str = "",
    ):
        self.queue_url = queue_url
        self.access_key, self.secret_key = access_key, secret_key
        self.region = region
        self.endpoint = endpoint.rstrip("/") or queue_url.rsplit("/", 2)[0]

    def _signed_headers(self, host: str, body: bytes) -> dict:
        from ..s3api.auth import IAM

        amz_date = datetime.now(timezone.utc).strftime("%Y%m%dT%H%M%SZ")
        date = amz_date[:8]
        payload_hash = hashlib.sha256(body).hexdigest()
        headers = {
            "Content-Type": "application/x-www-form-urlencoded",
            "Host": host,
            "X-Amz-Date": amz_date,
        }
        signed = "content-type;host;x-amz-date"
        canonical = "\n".join(
            [
                "POST",
                "/",
                "",
                f"content-type:{headers['Content-Type']}",
                f"host:{host}",
                f"x-amz-date:{amz_date}",
                "",
                signed,
                payload_hash,
            ]
        )
        scope = f"{date}/{self.region}/sqs/aws4_request"
        sts = "\n".join(
            [
                "AWS4-HMAC-SHA256",
                amz_date,
                scope,
                hashlib.sha256(canonical.encode()).hexdigest(),
            ]
        )
        key = IAM.signing_key(self.secret_key, date, self.region, "sqs")
        sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed}, Signature={sig}"
        )
        return headers

    def send(self, key, message):
        body = urllib.parse.urlencode(
            {
                "Action": "SendMessage",
                "QueueUrl": self.queue_url,
                "MessageBody": json.dumps({"key": key, "message": message}),
                "Version": "2012-11-05",
            }
        ).encode()
        host = urllib.parse.urlparse(self.endpoint).netloc
        req = urllib.request.Request(
            self.endpoint + "/",
            data=body,
            method="POST",
            headers=self._signed_headers(host, body),
        )
        try:
            # sweedlint: ok deadline-not-propagated SQS egress leaves the cluster; the internal deadline header must not leak
            with urllib.request.urlopen(req, timeout=10) as resp:
                if resp.status >= 300:
                    glog.warning("sqs send → %d", resp.status)
        except (urllib.error.URLError, OSError) as e:
            glog.warning("sqs send failed: %s", e)


class KafkaQueue(MessageQueue):
    """Gated on an installed kafka client (`notification/kafka`)."""

    def __init__(self, hosts: list[str], topic: str):
        try:
            from kafka import KafkaProducer  # type: ignore
        except ImportError as e:
            raise ImportError(
                "KafkaQueue needs the 'kafka-python' package; install it or "
                "use SqsQueue/WebhookQueue/FileQueue instead"
            ) from e
        self._producer = KafkaProducer(bootstrap_servers=hosts)
        self.topic = topic

    def send(self, key, message):
        self._producer.send(
            self.topic, key=key.encode(), value=json.dumps(message).encode()
        )


class PubSubQueue(MessageQueue):
    """Gated on google-cloud-pubsub (`notification/google_pub_sub`)."""

    def __init__(self, project_id: str, topic: str):
        try:
            from google.cloud import pubsub_v1  # type: ignore
        except ImportError as e:
            raise ImportError(
                "PubSubQueue needs 'google-cloud-pubsub'; install it or use "
                "SqsQueue/WebhookQueue/FileQueue instead"
            ) from e
        self._pub = pubsub_v1.PublisherClient()
        self._topic = self._pub.topic_path(project_id, topic)

    def send(self, key, message):
        self._pub.publish(
            self._topic, json.dumps(message).encode(), key=key
        )


def make_queue(conf) -> Optional[MessageQueue]:
    """notification.toml → the first enabled queue
    (`notification/configuration.go` LoadConfiguration)."""
    if not conf.get_bool("notification.enabled", True):
        return None
    if conf.get_bool("notification.log.enabled"):
        return LogQueue()
    if conf.get_bool("notification.file.enabled"):
        return FileQueue(conf.get("notification.file.path", "./events.jsonl"))
    if conf.get_bool("notification.webhook.enabled"):
        return WebhookQueue(conf.get("notification.webhook.url", ""))
    if conf.get_bool("notification.aws_sqs.enabled"):
        return SqsQueue(
            conf.get("notification.aws_sqs.sqs_queue_url", ""),
            conf.get("notification.aws_sqs.aws_access_key_id", ""),
            conf.get("notification.aws_sqs.aws_secret_access_key", ""),
            region=conf.get("notification.aws_sqs.region", "us-east-1"),
            endpoint=conf.get("notification.aws_sqs.endpoint", ""),
        )
    if conf.get_bool("notification.kafka.enabled"):
        hosts = conf.get("notification.kafka.hosts", [])
        if isinstance(hosts, str):  # WEED_* env override arrives as a string
            hosts = [h.strip() for h in hosts.split(",") if h.strip()]
        return KafkaQueue(
            list(hosts),
            conf.get("notification.kafka.topic", "seaweedfs"),
        )
    if conf.get_bool("notification.google_pub_sub.enabled"):
        return PubSubQueue(
            conf.get("notification.google_pub_sub.project_id", ""),
            conf.get("notification.google_pub_sub.topic", "seaweedfs"),
        )
    return None


class NotificationBus:
    """Attaches queues to a filer's meta log (filer_notify.go
    NotifyUpdateEvent → notification.Queue.SendMessage)."""

    def __init__(self, filer, prefix: str = "/"):
        self.filer = filer
        self.prefix = prefix
        self.queues: list[MessageQueue] = []
        self._attached = False
        # deliveries run on a worker thread: a slow/unreachable queue (a
        # webhook with a dropped SYN blocks for its full timeout) must never
        # sit inside the filer's mutation path
        self._pending: queue.Queue = queue.Queue(maxsize=10000)
        self._worker: Optional[threading.Thread] = None

    def add_queue(self, q: MessageQueue) -> "NotificationBus":
        self.queues.append(q)
        if not self._attached:
            self.filer.meta_log.subscribe(f"notify-{id(self)}", self._on_event)
            self._attached = True
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()
        return self

    def _on_event(self, ev) -> None:
        path = None
        if ev.new_entry:
            path = ev.new_entry.get("full_path")
        elif ev.old_entry:
            path = ev.old_entry.get("full_path")
        if path is None or not path.startswith(self.prefix):
            return
        msg = {
            "ts_ns": ev.ts_ns,
            "directory": ev.directory,
            "old_entry": ev.old_entry,
            "new_entry": ev.new_entry,
            "delete_chunks": ev.delete_chunks,
        }
        try:
            self._pending.put_nowait((path, msg))
        except queue.Full:
            glog.warning("notification backlog full, dropping %s", path)

    def _drain(self) -> None:
        while self._attached:
            try:
                path, msg = self._pending.get(timeout=0.5)
            except queue.Empty:
                continue
            for q in self.queues:
                try:
                    q.send(path, msg)
                except Exception as e:  # noqa: BLE001 — keep draining
                    glog.warning(
                        "queue %s failed for %s: %s", type(q).__name__, path, e
                    )

    def detach(self) -> None:
        if self._attached:
            self.filer.meta_log.unsubscribe(f"notify-{id(self)}")
            self._attached = False
