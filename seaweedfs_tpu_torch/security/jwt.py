"""Compact HS256 JWT, stdlib-only (reference `security/jwt.go`:
GenJwt signs {exp, fid}; volume servers verify the token covers the fid
being written)."""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Optional

_HEADER = {"alg": "HS256", "typ": "JWT"}


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def gen_jwt(signing_key: str, fid: str, expires_seconds: int = 10) -> str:
    """Short-lived token scoped to one fid (jwt.go GenJwt, default 10s)."""
    header = _b64(json.dumps(_HEADER, separators=(",", ":")).encode())
    payload = _b64(
        json.dumps(
            {"exp": int(time.time()) + expires_seconds, "fid": fid},
            separators=(",", ":"),
        ).encode()
    )
    msg = f"{header}.{payload}"
    sig = _b64(
        hmac.new(signing_key.encode(), msg.encode(), hashlib.sha256).digest()
    )
    return f"{msg}.{sig}"


def decode_jwt(signing_key: str, token: str) -> Optional[dict]:
    """Signature + expiry check; returns claims or None."""
    try:
        header, payload, sig = token.split(".")
    except ValueError:
        return None
    msg = f"{header}.{payload}"
    want = _b64(
        hmac.new(signing_key.encode(), msg.encode(), hashlib.sha256).digest()
    )
    if not hmac.compare_digest(want, sig):
        return None
    try:
        claims = json.loads(_unb64(payload))
    except (ValueError, json.JSONDecodeError):
        return None
    if claims.get("exp", 0) < time.time():
        return None
    return claims


def verify_fid_jwt(signing_key: str, token: str, fid: str) -> bool:
    """The token must be valid AND cover this exact fid (jwt.go:60)."""
    claims = decode_jwt(signing_key, token)
    if claims is None:
        return False
    # normalize "vid,key_cookie" vs "vid/key_cookie"
    return claims.get("fid", "").replace("/", ",") == fid.replace("/", ",")


def read_auth_query(signing_key: str, fid: str) -> str:
    """'?auth=<token>' query suffix for a fid-scoped read, or '' when the
    deployment runs open — the one spelling every read client shares."""
    if not signing_key:
        return ""
    return "?auth=" + gen_jwt(signing_key, fid)
