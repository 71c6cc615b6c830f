"""Filer: directory/metadata layer over the object store.

Mirrors `weed/filer/`: entries are paths with attributes and chunk lists of
object-store fids; stores are pluggable (sqlite replaces leveldb/SQL here);
every mutation feeds a meta log with subscribe/replay.

The port's copy of the JAX package's ``filer/`` for one filer: entries,
chunk math and manifests, the memory and sqlite stores, the meta log,
path rules, the filer core, the peer meta aggregator, and the HTTP client
(``client.FilerClient``; ``ring.make_client`` for one address). The
multi-filer ring and reshard and the other stores are not ported yet.
"""
