"""The page codec and the retry classifier of fault-tolerant execution
(counterpart of the codec and ``is_retryable_failure`` in
``trino_tpu/exec/fte.py``; reference: PagesSerdeUtil.java and
CompressingEncryptingPageSerializer.java).

A frame is: magic ``TTPG``, a flag byte (low bits the codec: none, zlib,
zstd; high bit AES-GCM encrypted), the CRC32 of the payload, its length
(8 bytes, little-endian), and the payload, an ``npz`` of the page's host
columns and null masks.  The tiered spill's disk tier (``exec/spill.py``)
writes its partition files as a sequence of such frames; frames are
byte-compatible with the reference's.

``TRINO_TPU_PAGE_CODEC`` picks the codec (read at import).  Unset, it is
zstd level 1 where the ``zstandard`` binding is installed and zlib level 1
where it is not (the card machine has none); an explicit ``zstd`` without
the binding fails at the first frame.  ``TRINO_TPU_EXCHANGE_KEY`` (hex, 16,
24 or 32 bytes) encrypts and authenticates frames.

``is_retryable_failure`` is the one retry classification of the port: a
template's probation failure (``engine._maybe_template_execute``) consults
it, as the reference's engine does.

Not ported yet: the spooling exchange and the fault-tolerant executor
(ROADMAP A7).
"""

from __future__ import annotations

import io
import os
import zlib

import numpy as np
import torch

__all__ = ["PAGE_CODEC", "serialize_page", "deserialize_page", "is_retryable_failure"]

_MAGIC = b"TTPG"
_CODECS = {"none": 0, "zlib": 1, "zstd": 2}
_ENC_FLAG = 0x80
PAGE_CODEC = os.environ.get("TRINO_TPU_PAGE_CODEC", "zstd")
if PAGE_CODEC not in _CODECS:  # pragma: no cover - config error
    raise ValueError(f"TRINO_TPU_PAGE_CODEC must be one of {sorted(_CODECS)}")
if PAGE_CODEC == "zstd" and os.environ.get("TRINO_TPU_PAGE_CODEC") is None:
    try:
        import zstandard  # noqa: F401
    except ImportError:
        PAGE_CODEC = "zlib"


def _exchange_key():
    h = os.environ.get("TRINO_TPU_EXCHANGE_KEY")
    if not h:
        return None
    key = bytes.fromhex(h)
    if len(key) not in (16, 24, 32):
        raise ValueError("TRINO_TPU_EXCHANGE_KEY must be 16/24/32 hex bytes")
    return key


def _compress(payload: bytes, codec: int) -> bytes:
    if codec == 1:
        return zlib.compress(payload, 1)
    if codec == 2:
        import zstandard

        return zstandard.ZstdCompressor(level=1).compress(payload)
    return payload


def _decompress(payload: bytes, codec: int) -> bytes:
    if codec == 1:
        return zlib.decompress(payload)
    if codec == 2:
        import zstandard

        return zstandard.ZstdDecompressor().decompress(payload)
    return payload


def serialize_page(columns, null_masks, compress: bool = True) -> bytes:
    """One frame of host columns and null masks (numpy arrays; a caller
    with device tensors reads them first, through its executor's counted
    ``_host``)."""
    arrays = {}
    for i, c in enumerate(columns):
        if isinstance(c, torch.Tensor):
            raise TypeError("serialize_page takes host arrays: read device "
                            "tensors through LocalExecutor._host first")
        arrays[f"c{i}"] = c
        if null_masks[i] is not None:
            arrays[f"n{i}"] = null_masks[i]
    buf = io.BytesIO()
    np.savez(buf, ncols=np.int64(len(columns)), **arrays)
    codec = _CODECS[PAGE_CODEC] if compress else 0
    payload = _compress(buf.getvalue(), codec)
    flag = codec
    key = _exchange_key()
    if key is not None:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM

        nonce = os.urandom(12)
        # the frame prefix is the AAD: a frame cannot be relabelled
        flag = codec | _ENC_FLAG
        payload = nonce + AESGCM(key).encrypt(nonce, payload, _MAGIC + bytes([flag]))
    crc = zlib.crc32(payload)
    return _MAGIC + bytes([flag]) + crc.to_bytes(4, "little") \
        + len(payload).to_bytes(8, "little") + payload


def deserialize_page(data: bytes):
    """-> (columns, null_masks) as numpy arrays; raises on a bad magic, a
    checksum mismatch, a missing key or a failed authentication."""
    if data[:4] != _MAGIC:
        raise ValueError("bad page frame magic")
    flag = data[4]
    crc = int.from_bytes(data[5:9], "little")
    length = int.from_bytes(data[9:17], "little")
    payload = data[17:17 + length]
    if zlib.crc32(payload) != crc:
        raise ValueError("page frame checksum mismatch")
    codec = flag & ~_ENC_FLAG
    if flag & _ENC_FLAG:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM

        key = _exchange_key()
        if key is None:
            raise ValueError("page frame is encrypted but TRINO_TPU_EXCHANGE_KEY is not set")
        payload = AESGCM(key).decrypt(payload[:12], payload[12:], _MAGIC + bytes([flag]))
    # allow_pickle: exact wide-decimal (object) columns pickle inside the
    # npz; frames are read only from the spill directory this process wrote
    z = np.load(io.BytesIO(_decompress(payload, codec)), allow_pickle=True)
    n = int(z["ncols"])
    cols = [z[f"c{i}"] for i in range(n)]
    nulls = [z[f"n{i}"] if f"n{i}" in z.files else None for i in range(n)]
    return cols, nulls


def is_retryable_failure(e: BaseException) -> bool:
    """Task-retry classification, the reference's (retry policies consult
    the error kind: USER_ERROR against INTERNAL and EXTERNAL, spi/ErrorType
    .java).  A deterministic error (bad SQL, an unsupported feature, a
    planner fault, a query past its memory limit, a fatal injected fault)
    fails alike on every attempt, so a retry burns the budget and hides the
    message; anything else (connector IO, a transient device error, a
    retryable injected fault) may retry.  The reference's set also holds
    ``QueryKilledError``, which the port gets with the cluster's killer
    (ROADMAP A7): it joins the set then."""
    from ..execution.faults import FatalInjectedFaultError
    from ..memory import QueryMemoryLimitError
    from ..spi.security import AccessDeniedError
    from ..sql.analyzer import SemanticError
    from ..sql.parser import ParseError

    deterministic = (SemanticError, ParseError, AccessDeniedError, NotImplementedError,
                     AssertionError, AttributeError, NameError, QueryMemoryLimitError,
                     FatalInjectedFaultError)
    return isinstance(e, Exception) and not isinstance(e, deterministic)
