"""AES-256-GCM chunk encryption.

Reference: `weed/util/cipher.go` — `Encrypt`/`Decrypt` with a fresh random
256-bit key per chunk; the key rides in the filer entry's chunk metadata
(`cipher_key`), so the object store holds only ciphertext and the filer
holds the keys (`filer_server_handlers_write_cipher.go`).

Implementation: ctypes over the system libcrypto (OpenSSL EVP AES-256-GCM)
— host-side crypto, same stance as the reference using Go's stdlib. The
wire format matches Go's `gcm.Seal(nonce, nonce, data, nil)`:
`nonce(12) || ciphertext || tag(16)`.

The port's copy of the JAX package's ``util/cipher.py``; both packages read and
write the same formats.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import threading

KEY_SIZE = 32
NONCE_SIZE = 12
TAG_SIZE = 16


class CipherError(Exception):
    pass


_lib = None
_lib_lock = threading.Lock()


def _crypto():
    global _lib
    with _lib_lock:
        if _lib is None:
            name = ctypes.util.find_library("crypto")
            if not name:
                raise CipherError("libcrypto not found on this host")
            lib = ctypes.CDLL(name)
            lib.EVP_CIPHER_CTX_new.restype = ctypes.c_void_p
            lib.EVP_aes_256_gcm.restype = ctypes.c_void_p
            for f in (
                lib.EVP_EncryptInit_ex,
                lib.EVP_DecryptInit_ex,
                lib.EVP_EncryptUpdate,
                lib.EVP_DecryptUpdate,
                lib.EVP_EncryptFinal_ex,
                lib.EVP_DecryptFinal_ex,
                lib.EVP_CIPHER_CTX_ctrl,
            ):
                f.restype = ctypes.c_int
                f.argtypes = None  # variadic-ish; we pass explicit c_types
            lib.EVP_CIPHER_CTX_free.restype = None
            _lib = lib
        return _lib


_EVP_CTRL_GCM_SET_IVLEN = 0x9
_EVP_CTRL_GCM_GET_TAG = 0x10
_EVP_CTRL_GCM_SET_TAG = 0x11


def gen_cipher_key() -> bytes:
    return os.urandom(KEY_SIZE)


def encrypt(plaintext: bytes, key: bytes) -> bytes:
    """nonce || ciphertext || tag (cipher.go Encrypt)."""
    if len(key) != KEY_SIZE:
        raise CipherError(f"key must be {KEY_SIZE} bytes")
    lib = _crypto()
    nonce = os.urandom(NONCE_SIZE)
    ctx = lib.EVP_CIPHER_CTX_new()
    if not ctx:
        raise CipherError("EVP_CIPHER_CTX_new failed")
    try:
        ctx_p = ctypes.c_void_p(ctx)
        if lib.EVP_EncryptInit_ex(ctx_p, ctypes.c_void_p(lib.EVP_aes_256_gcm()), None, None, None) != 1:
            raise CipherError("EncryptInit(cipher) failed")
        if lib.EVP_CIPHER_CTX_ctrl(ctx_p, _EVP_CTRL_GCM_SET_IVLEN, NONCE_SIZE, None) != 1:
            raise CipherError("SET_IVLEN failed")
        if lib.EVP_EncryptInit_ex(ctx_p, None, None, key, nonce) != 1:
            raise CipherError("EncryptInit(key) failed")
        out = ctypes.create_string_buffer(len(plaintext) + 16)
        outl = ctypes.c_int(0)
        total = 0
        if plaintext:
            if (
                lib.EVP_EncryptUpdate(
                    ctx_p, out, ctypes.byref(outl), plaintext, len(plaintext)
                )
                != 1
            ):
                raise CipherError("EncryptUpdate failed")
            total = outl.value
        if lib.EVP_EncryptFinal_ex(ctx_p, ctypes.byref(out, total), ctypes.byref(outl)) != 1:
            raise CipherError("EncryptFinal failed")
        total += outl.value
        tag = ctypes.create_string_buffer(TAG_SIZE)
        if lib.EVP_CIPHER_CTX_ctrl(ctx_p, _EVP_CTRL_GCM_GET_TAG, TAG_SIZE, tag) != 1:
            raise CipherError("GET_TAG failed")
        return nonce + out.raw[:total] + tag.raw
    finally:
        lib.EVP_CIPHER_CTX_free(ctypes.c_void_p(ctx))


def decrypt(blob: bytes, key: bytes) -> bytes:
    """Inverse of encrypt; raises CipherError on tag mismatch."""
    if len(key) != KEY_SIZE:
        raise CipherError(f"key must be {KEY_SIZE} bytes")
    if len(blob) < NONCE_SIZE + TAG_SIZE:
        raise CipherError("ciphertext too short")
    lib = _crypto()
    nonce = blob[:NONCE_SIZE]
    tag = blob[-TAG_SIZE:]
    ct = blob[NONCE_SIZE:-TAG_SIZE]
    ctx = lib.EVP_CIPHER_CTX_new()
    if not ctx:
        raise CipherError("EVP_CIPHER_CTX_new failed")
    try:
        ctx_p = ctypes.c_void_p(ctx)
        if lib.EVP_DecryptInit_ex(ctx_p, ctypes.c_void_p(lib.EVP_aes_256_gcm()), None, None, None) != 1:
            raise CipherError("DecryptInit(cipher) failed")
        if lib.EVP_CIPHER_CTX_ctrl(ctx_p, _EVP_CTRL_GCM_SET_IVLEN, NONCE_SIZE, None) != 1:
            raise CipherError("SET_IVLEN failed")
        if lib.EVP_DecryptInit_ex(ctx_p, None, None, key, nonce) != 1:
            raise CipherError("DecryptInit(key) failed")
        out = ctypes.create_string_buffer(max(len(ct), 1))
        outl = ctypes.c_int(0)
        total = 0
        if ct:
            if lib.EVP_DecryptUpdate(ctx_p, out, ctypes.byref(outl), ct, len(ct)) != 1:
                raise CipherError("DecryptUpdate failed")
            total = outl.value
        if (
            lib.EVP_CIPHER_CTX_ctrl(
                ctx_p, _EVP_CTRL_GCM_SET_TAG, TAG_SIZE, ctypes.c_char_p(tag)
            )
            != 1
        ):
            raise CipherError("SET_TAG failed")
        if lib.EVP_DecryptFinal_ex(ctx_p, ctypes.byref(out, total), ctypes.byref(outl)) != 1:
            raise CipherError("authentication failed (bad key or corrupt data)")
        total += outl.value
        return out.raw[:total]
    finally:
        lib.EVP_CIPHER_CTX_free(ctypes.c_void_p(ctx))
