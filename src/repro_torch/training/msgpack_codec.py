"""A MessagePack encoder and decoder for the subset a checkpoint manifest
uses: maps, arrays, str, int (plus nil and bool).

The JAX package writes its manifests with ``msgpack.packb``, which the
port may not import.  :func:`packb` gives the same bytes for this subset
(the smallest encoding of each int and length, str as UTF-8 ``str``
types, maps in insertion order), and :func:`unpackb` reads them back.
Any other type raises ``TypeError`` (packing) or ``ValueError``
(unpacking).
"""
from __future__ import annotations

import struct
from typing import Any, Tuple


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(n: int, fix_base: int, fix_max: int, codes, out) -> None:
    """A container or str header: the fix form, else 8/16/32-bit lengths
    (``codes`` lists the header bytes of the sized forms, None where the
    type has no such form)."""
    if n <= fix_max:
        out.append(fix_base | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n <= 0x7F:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF),
                                 (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= limit:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"msgpack: int {n} too large")
    else:
        for code, fmt, limit in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                 (0xD2, ">i", -0x80000000),
                                 (0xD3, ">q", -0x8000000000000000)):
            if n >= limit:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"msgpack: int {n} too small")


def unpackb(data: bytes) -> Any:
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError("msgpack: trailing bytes")
    return obj


_SIZED = {  # header byte -> (struct format, what follows)
    0xCC: (">B", "int"), 0xCD: (">H", "int"), 0xCE: (">I", "int"),
    0xCF: (">Q", "int"), 0xD0: (">b", "int"), 0xD1: (">h", "int"),
    0xD2: (">i", "int"), 0xD3: (">q", "int"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
}


def _unpack(buf: memoryview, off: int) -> Tuple[Any, int]:
    if off >= len(buf):
        raise ValueError("msgpack: truncated data")
    b = buf[off]
    off += 1
    if b <= 0x7F:
        return b, off
    if b >= 0xE0:
        return b - 0x100, off
    if 0xA0 <= b <= 0xBF:
        return _str(buf, off, b & 0x1F)
    if 0x90 <= b <= 0x9F:
        return _array(buf, off, b & 0x0F)
    if 0x80 <= b <= 0x8F:
        return _map(buf, off, b & 0x0F)
    if b in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[b], off
    if b not in _SIZED:
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")
    fmt, kind = _SIZED[b]
    size = struct.calcsize(fmt)
    if off + size > len(buf):
        raise ValueError("msgpack: truncated data")
    (n,) = struct.unpack_from(fmt, buf, off)
    off += size
    if kind == "int":
        return n, off
    return {"str": _str, "array": _array, "map": _map}[kind](buf, off, n)


def _str(buf: memoryview, off: int, n: int) -> Tuple[str, int]:
    if off + n > len(buf):
        raise ValueError("msgpack: truncated data")
    return bytes(buf[off:off + n]).decode("utf-8"), off + n


def _array(buf: memoryview, off: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        v, off = _unpack(buf, off)
        out.append(v)
    return out, off


def _map(buf: memoryview, off: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, off = _unpack(buf, off)
        v, off = _unpack(buf, off)
        out[k] = v
    return out, off
