"""Cluster plane: topology tree, volume layout and growth, sequencer, master
core and the fleet EC scheduler.

The port of the JAX package's ``cluster/`` modules that a single master
needs (``weed/topology`` + ``weed/sequence`` + the master's logic from
``weed/server/master_*.go``). Transport-agnostic: the master core works on
plain dicts and objects, and ``server/master_server.py`` wraps it in HTTP.
HA election (``election.py``), fid-range leases (``fid_lease.py``: the
master's grants and the filer's ``LeasedFidSource``) and the lifecycle
autopilot (``lifecycle.py``) ride on it.
"""
