"""S3 POST policy uploads — browser form uploads with signed policies.

Reference: `weed/s3api/s3api_object_handlers_postpolicy.go:20`
(PostPolicyBucketHandler), `weed/s3api/policy/postpolicyform.go`
(ParsePostPolicyForm / CheckPostPolicy), and the policy-signature checks in
`s3api_object_handlers_postpolicy.go:235-300`
(doesPolicySignatureMatch, V2 + V4 forms).

Flow (AWS sigv4-HTTPPOSTConstructPolicy): the server hands a client a
base64 policy document + a signature over it; the browser POSTs
multipart/form-data to the bucket URL carrying policy, signature,
credential fields, and the file. The server re-signs the policy with the
credential's secret, compares, then validates every form field against the
policy's conditions (eq / starts-with / content-length-range) and the
expiration.
"""

from __future__ import annotations

import base64
import binascii
import email.parser
import email.policy
import hashlib
import hmac
import json
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Optional


def parse_multipart_form(
    body: bytes, content_type: str
) -> tuple[dict[str, str], bytes, str]:
    """(form_values, file_bytes, file_name) from a multipart/form-data body.

    Field names are case-insensitive in the reference (http.Header); values
    keep their case. The `file` part must be last per the AWS spec — fields
    after it are ignored, like S3 does.
    """
    parser = email.parser.BytesParser(policy=email.policy.HTTP)
    msg = parser.parsebytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body
    )
    if not msg.is_multipart():
        raise ValueError("not a multipart form")
    values: dict[str, str] = {}
    file_bytes: Optional[bytes] = None
    file_name = ""
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if name is None:
            continue
        if name.lower() == "file":
            file_bytes = part.get_payload(decode=True) or b""
            file_name = part.get_filename() or ""
            break  # AWS ignores fields after the file part
        payload = part.get_payload(decode=True) or b""
        values[name.lower()] = payload.decode("utf-8", "replace")
    if file_bytes is None:
        raise FileNotFoundError("POST form has no file part")
    return values, file_bytes, file_name


@dataclass
class PostPolicy:
    expiration: Optional[datetime] = None
    # conditions keyed by lowercased field name (no $): (match_type, value)
    conditions: dict[str, tuple[str, str]] = field(default_factory=dict)
    length_min: int = -1
    length_max: int = -1


def parse_post_policy(policy_json: str) -> PostPolicy:
    """postpolicyform.go ParsePostPolicyForm: strict shape validation."""
    try:
        doc = json.loads(policy_json)
    except json.JSONDecodeError as e:
        raise ValueError(f"policy is not JSON: {e}")
    out = PostPolicy()
    exp = doc.get("expiration")
    if exp is not None:
        try:
            out.expiration = datetime.fromisoformat(
                exp.replace("Z", "+00:00")
            )
        except ValueError:
            raise ValueError(f"bad expiration {exp!r}")
    for cond in doc.get("conditions", []):
        if isinstance(cond, dict):
            # {"bucket": "x"} is shorthand for ["eq", "$bucket", "x"]
            for k, v in cond.items():
                out.conditions[str(k).lower()] = ("eq", str(v))
            continue
        if not isinstance(cond, list) or not cond:
            raise ValueError(f"bad condition {cond!r}")
        op = str(cond[0]).lower()
        if op == "content-length-range":
            if len(cond) != 3:
                raise ValueError("content-length-range needs [op, min, max]")
            out.length_min, out.length_max = int(cond[1]), int(cond[2])
            continue
        if op not in ("eq", "starts-with") or len(cond) != 3:
            raise ValueError(f"unsupported condition {cond!r}")
        key = str(cond[1])
        if not key.startswith("$"):
            raise ValueError(f"condition key must start with $: {key!r}")
        out.conditions[key[1:].lower()] = (op, str(cond[2]))
    return out


# form fields that need not be declared as policy conditions ("bucket" is
# URL-derived — the gateway injects it into values — not a browser field)
_NO_DECLARE = {
    "policy", "x-amz-signature", "file", "awsaccesskeyid", "signature",
    "x-amz-credential", "x-amz-algorithm", "x-amz-date", "bucket",
}
# declared conditions that are validated elsewhere (signature plumbing);
# NOT "bucket" — a signed ["eq", "$bucket", ...] must bind the form to that
# bucket or the signature could be replayed against another bucket
_SKIP_CHECK = _NO_DECLARE - {"bucket"}


def check_post_policy(values: dict[str, str], policy: PostPolicy) -> None:
    """CheckPostPolicy (postpolicyform.go): expiration + every policy
    condition must hold against the form values, AND every non-exempt form
    field must be declared in the conditions (a field the signer never
    authorized — success_action_redirect, content-type, … — is rejected,
    matching AWS/minio semantics). Raises ValueError."""
    if policy.expiration is not None:
        now = datetime.now(timezone.utc)
        exp = policy.expiration
        if exp.tzinfo is None:
            exp = exp.replace(tzinfo=timezone.utc)
        if now > exp:
            raise ValueError("policy expired")
    for key, (op, want) in policy.conditions.items():
        if key in _SKIP_CHECK or key == "content-length-range":
            continue
        got = values.get(key)
        if got is None:
            # the reference tolerates policy conditions on fields that the
            # form omits only for x-amz-meta-*; everything else must match
            if key.startswith("x-amz-meta-"):
                continue
            raise ValueError(f"form is missing policy field {key!r}")
        if op == "eq" and got != want:
            raise ValueError(f"{key}: {got!r} != {want!r}")
        if op == "starts-with" and not got.startswith(want):
            raise ValueError(f"{key}: {got!r} !startswith {want!r}")
    for key in values:
        if key in _NO_DECLARE or key.startswith("x-ignore-"):
            continue
        if key not in policy.conditions:
            raise ValueError(f"form field {key!r} not declared in policy")


def verify_policy_signature_v4(
    values: dict[str, str], secret_for_access_key
) -> Optional[str]:
    """doesPolicySignatureV4Match: HMAC chain over the base64 policy.
    Returns the access key on success, None on mismatch."""
    from .auth import IAM

    cred = values.get("x-amz-credential", "")
    parts = cred.split("/")
    if len(parts) != 5:
        return None
    access_key, date, region, service, _ = parts
    secret = secret_for_access_key(access_key)
    if secret is None:
        return None
    key = IAM.signing_key(secret, date, region, service)
    want = hmac.new(
        key, values.get("policy", "").encode(), hashlib.sha256
    ).hexdigest()
    given = values.get("x-amz-signature", "")
    return access_key if hmac.compare_digest(want, given) else None


def verify_policy_signature_v2(
    values: dict[str, str], secret_for_access_key
) -> Optional[str]:
    """doesPolicySignatureV2Match: base64(HMAC-SHA1(secret, policy))."""
    access_key = values.get("awsaccesskeyid", "")
    secret = secret_for_access_key(access_key)
    if secret is None:
        return None
    want = base64.b64encode(
        hmac.new(
            secret.encode(), values.get("policy", "").encode(), hashlib.sha1
        ).digest()
    ).decode()
    given = values.get("signature", "")
    return access_key if hmac.compare_digest(want, given) else None


def decode_policy(values: dict[str, str]) -> str:
    try:
        return base64.b64decode(values.get("policy", "")).decode()
    except (binascii.Error, UnicodeDecodeError) as e:
        raise ValueError(f"bad policy encoding: {e}")
