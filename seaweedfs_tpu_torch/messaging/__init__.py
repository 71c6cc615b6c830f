"""Pub/sub message broker on the filer (reference: `weed/messaging/`): the
port of the JAX package's ``messaging/``.

Kafka-lite: topics/partitions are filer directories under
`/topics/<namespace>/<topic>/<partition>`; published messages append to an
in-memory log buffer (``log_buffer.LogBuffer``) flushed as segment files;
subscribers replay persisted segments then tail the live buffer
(``broker.Broker``); partition→broker placement uses a consistent-hash
ring (``consistent.ConsistentRing``, also the filer fleet's placement), and
``client.MessagingClient`` publishes and subscribes. The frames and the
``.seg`` files are the JAX package's.
"""

from .broker import Broker, TopicManager  # noqa: F401
from .client import MessagingClient  # noqa: F401
from .consistent import ConsistentRing  # noqa: F401
from .log_buffer import LogBuffer  # noqa: F401
