"""Filer: directory/metadata layer over the object store.

Mirrors `weed/filer/`: entries are paths with attributes and chunk lists of
object-store fids; stores are pluggable (sqlite replaces leveldb/SQL here);
every mutation feeds a meta log with subscribe/replay.

The port's copy of the JAX package's ``filer/``: entries, chunk math and
manifests, the stores (memory, sqlite and any DB-API SQL driver, redis, and
the SDK-gated cassandra, mongodb, etcd and elastic), the meta log, path
rules, the filer core, the peer meta aggregator, the HTTP client
(``client.FilerClient``), the sharded fleet's ring (``ring.FilerRing``,
``ring.RingFilerClient``, ``ring.make_client``) and its subtree reshard
(``reshard.Resharder``).
"""
