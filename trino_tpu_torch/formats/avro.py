"""Minimal Avro object-container-file reader/writer (no external deps;
counterpart of ``trino_tpu/formats/avro.py``: the same code).

Reference: the reference consumes Iceberg manifests through its Avro readers
(lib/trino-hive-formats/.../avro/, plugin/trino-iceberg's manifest readers).
This is the spec-compliant subset those files need: the 1.x object container
format (magic, metadata map, sync markers, blocks) with null/deflate codecs,
and the binary encoding for null/boolean/int/long (zigzag varint)/float/
double/bytes/string/fixed/enum/array/map/union/record.  Files are
SELF-DESCRIBING (the writer schema is embedded), so reading needs no external
schema and returns plain Python dicts/lists — manifest files are tiny
metadata, never the data path.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib

__all__ = ["read_container", "write_container"]

_MAGIC = b"Obj\x01"


# ---------------------------------------------------------------------------- decode
class _Reader:
    def __init__(self, data: bytes):
        self.b = data
        self.pos = 0

    def read(self, n: int) -> bytes:
        out = self.b[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated avro data")
        self.pos += n
        return out

    def long(self) -> int:
        """Zigzag varint."""
        shift = 0
        acc = 0
        while True:
            byte = self.b[self.pos]
            self.pos += 1
            acc |= (byte & 0x7F) << shift
            if not (byte & 0x80):
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)

    def value(self, schema):
        if isinstance(schema, str):
            kind = schema
        elif isinstance(schema, list):  # union: branch index then value
            return self.value(schema[self.long()])
        else:
            kind = schema["type"]
        if kind == "null":
            return None
        if kind == "boolean":
            return self.read(1) != b"\x00"
        if kind in ("int", "long"):
            return self.long()
        if kind == "float":
            return struct.unpack("<f", self.read(4))[0]
        if kind == "double":
            return struct.unpack("<d", self.read(8))[0]
        if kind in ("bytes",):
            return self.read(self.long())
        if kind == "string":
            return self.read(self.long()).decode("utf-8")
        if kind == "fixed":
            return self.read(schema["size"])
        if kind == "enum":
            return schema["symbols"][self.long()]
        if kind == "array":
            out = []
            while True:
                n = self.long()
                if n == 0:
                    break
                if n < 0:  # negative block count: byte size follows
                    self.long()
                    n = -n
                for _ in range(n):
                    out.append(self.value(schema["items"]))
            return out
        if kind == "map":
            out = {}
            while True:
                n = self.long()
                if n == 0:
                    break
                if n < 0:
                    self.long()
                    n = -n
                for _ in range(n):
                    k = self.read(self.long()).decode("utf-8")
                    out[k] = self.value(schema["values"])
            return out
        if kind == "record":
            return {f["name"]: self.value(f["type"])
                    for f in schema["fields"]}
        raise NotImplementedError(f"avro type {kind!r}")


def read_container(path: str):
    """-> (records, metadata): every record of the file, decoded by the
    embedded writer schema; metadata = the header's string map."""
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(data)
    if r.read(4) != _MAGIC:
        raise ValueError(f"{path}: not an avro object container file")
    meta = r.value({"type": "map", "values": "bytes"})
    schema = json.loads(meta["avro.schema"].decode())
    codec = meta.get("avro.codec", b"null").decode()
    sync = r.read(16)
    records = []
    while r.pos < len(data):
        n = r.long()
        size = r.long()
        block = r.read(size)
        if codec == "deflate":
            block = zlib.decompress(block, -15)  # raw deflate per the spec
        elif codec != "null":
            raise NotImplementedError(f"avro codec {codec!r}")
        if r.read(16) != sync:
            raise ValueError(f"{path}: sync marker mismatch")
        br = _Reader(block)
        for _ in range(n):
            records.append(br.value(schema))
    return records, meta


# ---------------------------------------------------------------------------- encode
class _Writer:
    def __init__(self):
        self.buf = io.BytesIO()

    def write(self, b: bytes):
        self.buf.write(b)

    def value(self, schema, v):
        if isinstance(schema, str):
            kind = schema
        elif isinstance(schema, list):
            # union: pick the first matching branch
            for i, branch in enumerate(schema):
                name = branch if isinstance(branch, str) else branch["type"]
                if v is None and name == "null":
                    self.long_raw(i)
                    return
                if v is not None and name != "null":
                    self.long_raw(i)
                    self.value(branch, v)
                    return
            raise ValueError(f"no union branch for {v!r}")
        else:
            kind = schema["type"]
        if kind == "null":
            return
        if kind == "boolean":
            self.write(b"\x01" if v else b"\x00")
        elif kind in ("int", "long"):
            self.long_raw(v)
        elif kind == "float":
            self.write(struct.pack("<f", v))
        elif kind == "double":
            self.write(struct.pack("<d", v))
        elif kind == "bytes":
            self.long_raw(len(v))
            self.write(bytes(v))
        elif kind == "string":
            b = v.encode("utf-8")
            self.long_raw(len(b))
            self.write(b)
        elif kind == "fixed":
            self.write(bytes(v))
        elif kind == "array":
            if v:
                self.long_raw(len(v))
                for item in v:
                    self.value(schema["items"], item)
            self.long_raw(0)
        elif kind == "map":
            if v:
                self.long_raw(len(v))
                for k, mv in v.items():
                    self.value("string", k)
                    self.value(schema["values"], mv)
            self.long_raw(0)
        elif kind == "record":
            for f in schema["fields"]:
                self.value(f["type"], v[f["name"]])
        else:
            raise NotImplementedError(f"avro type {kind!r}")

    def long_raw(self, v: int):
        """Zigzag varint encode (python ints: v >> 63 is 0 or -1, so the XOR
        yields 2v for v >= 0 and -2v-1 for v < 0 — the spec's mapping)."""
        n = (v << 1) ^ (v >> 63)
        while True:
            b = n & 0x7F
            n >>= 7
            if n:
                self.buf.write(bytes([b | 0x80]))
            else:
                self.buf.write(bytes([b]))
                break


def write_container(path: str, schema: dict, records, codec: str = "null"):
    """Write an Avro object container file (used by tests to fabricate
    Iceberg manifests, and by any future metadata writer)."""
    w = _Writer()
    w.write(_MAGIC)
    meta = {"avro.schema": json.dumps(schema).encode(),
            "avro.codec": codec.encode()}
    w.value({"type": "map", "values": "bytes"}, meta)
    sync = os.urandom(16)
    w.write(sync)
    body = _Writer()
    for rec in records:
        body.value(schema, rec)
    block = body.buf.getvalue()
    if codec == "deflate":
        c = zlib.compressobj(wbits=-15)
        block = c.compress(block) + c.flush()
    elif codec != "null":
        raise NotImplementedError(f"avro codec {codec!r}")
    w.long_raw(len(records))
    w.long_raw(len(block))
    w.write(block)
    w.write(sync)
    with open(path, "wb") as f:
        f.write(w.buf.getvalue())
