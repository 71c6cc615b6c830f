"""Named remote backends for the cloud tier.

The reference keeps S3 credentials in the master's ``[storage.backend.s3.*]``
configuration, and a volume names its backend (`volume_tier.go`: the .vif
carries the backend's name and the key). Here a descriptor carries
``{"backend": "s3.default"}`` and the secrets live only in ``backend.toml``
(searched in ``.``, ``~/.seaweedfs_tpu``, ``/etc/seaweedfs``; ``WEED_*``
environment variables override it):

    [s3.default]
    endpoint = "https://s3.us-east-1.amazonaws.com"
    access_key = ""
    secret_key = ""
"""

from __future__ import annotations

from typing import Optional

from ..util.config import Configuration, load_configuration


class BackendConfigError(KeyError):
    pass


def resolve_backend(name: str, conf: Optional[Configuration] = None) -> dict:
    """A backend's name ("s3.default") -> {endpoint, access_key, secret_key}."""
    conf = conf or load_configuration("backend")
    endpoint = conf.get(f"{name}.endpoint")
    if endpoint is None:
        raise BackendConfigError(
            f"backend {name!r} not defined in backend.toml "
            f"(searched {conf.path or 'standard paths'})")
    return {
        "endpoint": endpoint,
        "access_key": conf.get(f"{name}.access_key", "") or "",
        "secret_key": conf.get(f"{name}.secret_key", "") or "",
    }
