"""Filer: directory/metadata layer over the object store.

Mirrors `weed/filer/`: entries are paths with attributes and chunk lists of
object-store fids; stores are pluggable (sqlite replaces leveldb/SQL here);
every mutation feeds a meta log with subscribe/replay.

The port's copy of the JAX package's ``filer/`` for one filer: entries,
chunk math and manifests, the memory and sqlite stores, the meta log,
path rules, the filer core and the peer meta aggregator. The multi-filer
ring and reshard, the filer client and the other stores are not ported
yet.
"""
