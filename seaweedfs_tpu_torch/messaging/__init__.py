"""Messaging: the port holds only the consistent-hash ring
(``consistent.ConsistentRing``) that the sharded filer fleet places its
subtrees with. The JAX package's broker, client and log buffer are not
ported yet.
"""

from .consistent import ConsistentRing  # noqa: F401
