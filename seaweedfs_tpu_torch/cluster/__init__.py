"""Cluster plane: topology tree, volume layout and growth, sequencer, master
core and the fleet EC scheduler.

The port of the JAX package's ``cluster/`` modules that a single master
needs (``weed/topology`` + ``weed/sequence`` + the master's logic from
``weed/server/master_*.go``). Transport-agnostic: the master core works on
plain dicts and objects, and ``server/master_server.py`` wraps it in HTTP.
Election, fid leases and the lifecycle autopilot are not ported yet.
"""
