"""TOML configuration with environment overrides (`weed/util/config.go`,
viper).

The search path is the reference's: ``.``, ``$HOME/.seaweedfs_tpu``,
``/etc/seaweedfs``. A value resolves in this order:

1. a ``WEED_``-prefixed environment variable (viper's AutomaticEnv): the key
   ``s3.default.endpoint`` reads ``WEED_S3_DEFAULT_ENDPOINT``;
2. the TOML file ``<name>.toml`` from the first directory that has one;
3. the caller's default.

The port reads ``backend.toml`` (the named remote tiers of
``storage/backend_config.py``) and, for the ``filer`` command,
``filer.toml`` and ``notification.toml``.
"""

from __future__ import annotations

import os
import tomllib
from typing import Any

from . import glog

SEARCH_PATHS = [".", os.path.expanduser("~/.seaweedfs_tpu"), "/etc/seaweedfs"]


class Configuration:
    def __init__(self, data: dict, name: str, path: str = ""):
        self._data = data
        self._name = name
        self.path = path

    def get(self, key: str, default: Any = None) -> Any:
        """A dotted key, a ``WEED_`` environment variable first."""
        env = "WEED_" + key.upper().replace(".", "_").replace("-", "_")
        if env in os.environ:
            return os.environ[env]
        node: Any = self._data
        for part in key.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key, default)
        if isinstance(v, str):
            return v.lower() in ("1", "true", "yes", "on")
        return bool(v)


def load_configuration(name: str) -> Configuration:
    """``<name>.toml`` from the first directory of the search path that has
    a readable one; an empty configuration when none has."""
    for d in SEARCH_PATHS:
        path = os.path.join(d, f"{name}.toml")
        if os.path.exists(path):
            try:
                with open(path, "rb") as f:
                    data = tomllib.load(f)
            except (OSError, tomllib.TOMLDecodeError) as e:
                glog.error("config %s unreadable: %s", path, e)
                continue
            glog.V(1).info("loaded %s", path)
            return Configuration(data, name, path)
    return Configuration({}, name)
