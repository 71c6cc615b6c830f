"""Path-prefix storage rules (FilerConf).

Reference: `weed/filer/filer_conf.go` — a config entry stored INSIDE the
filer at `/etc/seaweedfs/filer.conf` holds per-path-prefix storage
options (collection, replication, ttl, fsync); the longest matching
prefix wins. The reference stores protobuf text; this build stores JSON:

    {"locations": [
        {"location_prefix": "/buckets/media/", "collection": "media",
         "replication": "010", "ttl": "30d", "fsync": false}
    ]}

The port's copy of the JAX package's ``filer/filer_conf.py``; both packages read and
write the same formats.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

DIR_ETC = "/etc/seaweedfs"
FILER_CONF_NAME = "filer.conf"
FILER_CONF_PATH = f"{DIR_ETC}/{FILER_CONF_NAME}"


@dataclass
class PathConf:
    location_prefix: str = ""
    collection: str = ""
    replication: str = ""
    ttl: str = ""
    fsync: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "PathConf":
        return cls(
            location_prefix=d.get("location_prefix", ""),
            collection=d.get("collection", ""),
            replication=d.get("replication", ""),
            ttl=d.get("ttl", ""),
            fsync=bool(d.get("fsync", False)),
        )


@dataclass
class FilerConf:
    locations: list[PathConf] = field(default_factory=list)

    @classmethod
    def from_bytes(cls, data: bytes) -> "FilerConf":
        try:
            doc = json.loads(data or b"{}")
        except json.JSONDecodeError:
            return cls()
        return cls(
            locations=[PathConf.from_dict(d) for d in doc.get("locations", [])]
        )

    def match_storage_rule(self, path: str) -> PathConf:
        """Longest matching location_prefix wins (filer_conf.go MatchStorageRule)."""
        best = PathConf()
        for rule in self.locations:
            if rule.location_prefix and path.startswith(rule.location_prefix):
                if len(rule.location_prefix) > len(best.location_prefix):
                    best = rule
        return best

    # -- editing (fs.configure / command_fs_configure.go) --------------------
    def set_rule(
        self,
        location_prefix: str,
        collection: str = "",
        replication: str = "",
        ttl: str = "",
        fsync: bool = False,
    ) -> None:
        """Upsert the rule for a prefix (AddLocationConf semantics)."""
        self.delete_prefix(location_prefix)
        self.locations.append(
            PathConf(
                location_prefix=location_prefix,
                collection=collection,
                replication=replication,
                ttl=ttl,
                fsync=fsync,
            )
        )

    def delete_prefix(self, location_prefix: str) -> None:
        self.locations = [
            r for r in self.locations if r.location_prefix != location_prefix
        ]

    def to_dict(self) -> dict:
        return {
            "locations": [
                {
                    "location_prefix": r.location_prefix,
                    "collection": r.collection,
                    "replication": r.replication,
                    "ttl": r.ttl,
                    "fsync": r.fsync,
                }
                for r in self.locations
            ]
        }

    def to_bytes(self) -> bytes:
        return json.dumps(self.to_dict(), indent=2).encode()
