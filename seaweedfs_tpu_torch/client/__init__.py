"""Stand-alone client package: the fsspec adapter over the filer (the
reference's HDFS adapter, `other/java/hdfs2`) and the plain ``FilerClient``.
The port of the JAX package's ``client/``.

Usage::

    import fsspec
    from seaweedfs_tpu_torch.client import register
    register()
    fs = fsspec.filesystem("seaweedfs", filer="127.0.0.1:8888")

``fsspec`` is imported when the adapter is first used, not when this
package is imported: ``SeaweedFileSystem`` and ``SeaweedFile`` are built on
first access.
"""

from ..filer.client import FilerClient  # noqa: F401 — entry-level client
from . import fs as _fs
from .fs import register  # noqa: F401

__all__ = ["FilerClient", "SeaweedFile", "SeaweedFileSystem", "register"]


def __getattr__(name: str):
    if name in ("SeaweedFileSystem", "SeaweedFile"):
        return getattr(_fs, name)
    raise AttributeError(name)
