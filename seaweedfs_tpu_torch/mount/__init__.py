"""Mount layer: a filesystem view over the filer. The port of the JAX
package's ``mount/`` (after `weed/filesys/` and `weed/command/mount_std.go`):

- ``wfs.WFS``: the virtual filesystem (lookup, read, write through
  dirty-page intervals, flush, rename, xattrs) over the filer;
- ``fuse_mount.FuseMount``: the kernel-visible mount, a ctypes binding of
  libfuse 2.x over ``WFS`` (``fuse_available()`` gates it);
- ``sync``: ``copy_to_filer``/``copy_from_filer`` (`weed filer.copy`) and
  ``MountSync``, the FUSE-less local-directory sync daemon;
- ``meta_cache.MetaCache``: the sqlite mirror of filer entries kept fresh
  from the filer's meta events.

Nothing here touches the card: the data lives in chunks on the volume
servers, so a read of a sealed chunk whose shard is lost is rebuilt there,
by ``gf_matmul``.
"""

from .dirty_pages import ContinuousIntervals
from .meta_cache import MetaCache
from .wfs import WFS, FileHandle

__all__ = ["WFS", "FileHandle", "ContinuousIntervals", "MetaCache"]
