"""TLS / mTLS contexts for the HTTP plane: the port of the JAX package's
``security/tls.py``.

Mirrors `weed/security/tls.go`: servers load a cert/key pair and — when a
CA is configured — require and verify client certificates
(`tls.go:22,37` RequireAndVerifyClientCert); clients present their own
pair and pin the cluster CA. Certificate paths come from security.toml:

    [tls]
    ca = "/etc/seaweedfs/ca.crt"          # enables mTLS when set

    [tls.master]   # per-component pairs, like [grpc.master] in the
    cert = ""      # reference's security.toml
    key = ""

    [tls.volume]
    cert = ""
    key = ""

    [tls.client]
    cert = ""
    key = ""

The S3 gateway takes ``-cert.file``/``-key.file``/``-caCert.file`` flags
directly, as ``weed s3 -cert.file`` does (`command/s3.go:42`).
"""

from __future__ import annotations

import ssl
from typing import Optional


def server_context(
    cert_file: str, key_file: str = "", ca_file: str = ""
) -> ssl.SSLContext:
    """TLS termination; with ca_file, clients must present a CA-signed
    certificate (mTLS). An empty key_file means a combined cert+key PEM."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_file, key_file or cert_file)
    if ca_file:
        ctx.load_verify_locations(ca_file)
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def optional_server_context(
    cert_file: str, key_file: str = "", ca_file: str = ""
) -> Optional[ssl.SSLContext]:
    """(cert, key, ca) from flags/config → context, None when all empty
    (plaintext). key/ca WITHOUT a cert is a misconfiguration — refusing is
    safer than silently starting plaintext with the CA ignored."""
    if not (cert_file or key_file or ca_file):
        return None
    if not cert_file:
        raise ValueError(
            "TLS misconfigured: -key.file/-caCert.file given without "
            "-cert.file (refusing to start plaintext)"
        )
    return server_context(cert_file, key_file, ca_file)


def client_context(
    ca_file: str = "",
    cert_file: str = "",
    key_file: str = "",
    insecure: bool = False,
) -> ssl.SSLContext:
    """Pinned-CA (and optionally client-cert) https context. Without a CA
    the SYSTEM trust store verifies the server; disabling verification is
    explicit opt-in only — a client cert with no CA must not silently
    accept any server (MITM)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    if ca_file:
        ctx.load_verify_locations(ca_file)
    elif insecure:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    else:
        ctx.load_default_certs()
    if cert_file:
        ctx.load_cert_chain(cert_file, key_file or cert_file)
    return ctx
