"""``seal_rebuild_wall_GBps``: the .dat bytes of the window's cycles over
their summed round trips on the host's clock (``/admin/ec/generate``,
``/admin/ec/delete_shards``, ``/admin/ec/rebuild``): what an operator waits
for a seal and for the rebuild of what was lost, taken by the seal cell's
driver."""


def read(run):
    return run["host"].get("seal_rebuild_wall_GBps")
