"""Cross-cluster replication: the port's copy of the JAX package's
``replication/`` (reference: `weed/replication/`, `weed/notification/`,
`weed/command/filer_sync.go`).

- `sink`: ReplicationSink implementations — another filer cluster, an
  S3-compatible endpoint, or a local directory.
- `cloud_sinks`: GCS (XML interop), Backblaze B2 (S3 API), Azure Blob
  (native SharedKey REST) + the replication.toml sink factory.
- `replicator`: maps filer meta events (create/update/delete) to sink calls.
- `notification`: pluggable queues publishing filer meta events — memory,
  JSONL file, log, webhook, native-SigV4 SQS, gated kafka/pubsub.
- `filer_sync`: continuous active-active or active-passive sync between two
  filer clusters with signature-based loop prevention, crash-idempotent
  apply (KV markers + batch offset checkpoints), LWW conflict resolution,
  and bounded per-event retry.
- `controller`: `ReplicationController` owning both directions of an
  active-active pair, with per-direction dead-letter queues and the
  `sync_stats()` snapshot behind the `sweed_sync_*` gauges.

Markers, offsets, signatures and queue records are the JAX package's, so a
port FilerSync resumes a JAX one's work and either package's filer is a
source or a target.
"""

from .replicator import Replicator  # noqa: F401
from .sink import FilerSink, LocalFsSink, S3Sink  # noqa: F401
from .cloud_sinks import AzureSink, B2Sink, GcsSink, make_sink  # noqa: F401
from .filer_sync import FilerSync, SyncStalled  # noqa: F401
from .controller import (  # noqa: F401
    DeadLetterQueue,
    ReplicationController,
    sync_stats,
)
from .notification import (  # noqa: F401
    FileQueue,
    LogQueue,
    MemoryQueue,
    NotificationBus,
    SqsQueue,
    WebhookQueue,
    make_queue,
)
