"""TOML configuration with environment overrides (`weed/util/config.go`,
viper).

The search path is the reference's: ``.``, ``$HOME/.seaweedfs_tpu``,
``/etc/seaweedfs``. A value resolves in this order:

1. a ``WEED_``-prefixed environment variable (viper's AutomaticEnv): the key
   ``s3.default.endpoint`` reads ``WEED_S3_DEFAULT_ENDPOINT``;
2. the TOML file ``<name>.toml`` from the first directory that has one;
3. the caller's default.

The port reads ``backend.toml`` (the named remote tiers of
``storage/backend_config.py``), for the ``filer`` command ``filer.toml``
(its store) and ``notification.toml`` (its event queue), and for
``filer.replicate`` ``replication.toml`` (its sink).
``SCAFFOLDS`` holds the starter templates that ``scaffold -config=<name>``
prints, the JAX package's text for text.
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

    def sub(self, prefix: str) -> dict:
        """The raw table under a prefix (``filer.toml``'s ``[sql]``: the
        driver's connect arguments)."""
        v = self.get(prefix, {})
        return v if isinstance(v, dict) else {}


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


# the templates `weed scaffold -config=<name>` prints (the JAX package's)
SCAFFOLDS = {
    "security": """\
# security.toml — put in ., ~/.seaweedfs_tpu, or /etc/seaweedfs
# (reference: weed scaffold -config=security → security.toml)

[jwt.signing]
# shared secret: volume servers verify fid-scoped write JWTs minted by the
# master when this is non-empty
key = ""
expires_after_seconds = 10

[jwt.signing.read]
key = ""

[guard]
# ip whitelist for admin/write surfaces; empty = allow all
white_list = []

[tls]
# cluster CA; when set, TLS-enabled servers REQUIRE CA-signed client
# certificates (mTLS, like the reference's [grpc] ca)
ca = ""

[tls.s3]
cert = ""
key = ""

[tls.webdav]
cert = ""
key = ""

[tls.client]
cert = ""
key = ""
""",
    "master": """\
# master.toml

[master.volume_growth]
# how many volumes to grow per type when one fills
copy_1 = 7
copy_2 = 6
copy_3 = 3

[master.maintenance]
garbage_threshold = 0.3
""",
    "filer": """\
# filer.toml — filer store selection (first enabled store wins)

[sqlite]
enabled = true
dbFile = "./filer.db"

[memory]
enabled = false

[redis]
enabled = false
address = "localhost:6379"
password = ""
database = 0

[sql]
# any DB-API 2.0 driver importable by name (mysql/postgres clients);
# remaining keys in this table are passed to driver.connect(**kwargs)
enabled = false
driver = "pymysql"
""",
    "replication": """\
# replication.toml — sink for weed filer.replicate

[sink.local]
enabled = false
directory = "/backup"

[sink.filer]
enabled = false
grpcAddress = "localhost:8888"

[sink.s3]
enabled = false
endpoint = "http://127.0.0.1:8333"
bucket = "mirror"

[sink.gcs]
# GCS XML/interop API with HMAC keys
enabled = false
bucket = "mirror"
access_key = ""
secret_key = ""
directory = ""

[sink.backblaze]
# B2 via its S3-compatible endpoint
enabled = false
bucket = "mirror"
b2_account_id = ""
b2_master_application_key = ""
region = "us-west-004"

[sink.azure]
# native Blob REST with SharedKey signing
enabled = false
account_name = ""
account_key = ""
container = "mirror"
directory = ""
""",
    "backend": """\
# backend.toml — named remote storage backends for cloud tiering.
# Volumes tiered with -backend=s3.default store only the backend NAME in
# their .tier descriptor; the credentials live here, not in the data dirs.

[s3.default]
endpoint = "https://s3.us-east-1.amazonaws.com"
access_key = ""
secret_key = ""
""",
    "notification": """\
# notification.toml — filer event bus (first enabled queue wins)

[notification.log]
enabled = true

[notification.file]
enabled = false
path = "./events.jsonl"

[notification.webhook]
enabled = false
url = "http://127.0.0.1:9000/events"

[notification.aws_sqs]
enabled = false
aws_access_key_id = ""
aws_secret_access_key = ""
region = "us-east-1"
sqs_queue_url = ""

[notification.kafka]
enabled = false
hosts = ["kafka1:9092"]
topic = "seaweedfs_filer"

[notification.google_pub_sub]
enabled = false
project_id = ""
topic = "seaweedfs_filer"
""",
}
