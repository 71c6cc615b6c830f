"""Security: per-fid JWT write/read auth + IP whitelist guard
(reference: `weed/security/jwt.go`, `guard.go`).

The master signs a short-lived fid-scoped token into every assign response;
volume servers verify it on writes (and on reads when a read key is set).
Keys are shared secrets (HS256), distributed via config, as
`security.toml` [jwt.signing] / [jwt.signing.read].
"""

from .guard import Guard  # noqa: F401
from .jwt import decode_jwt, gen_jwt, read_auth_query, verify_fid_jwt  # noqa: F401
