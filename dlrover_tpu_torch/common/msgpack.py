"""A msgpack codec for the subset the control plane and the frame header use.

The JAX package frames its shm checkpoint header, its agent IPC and its
master RPC with the ``msgpack`` package; the card machine does not install
it, so the port carries its own codec for nil, bool, int, float64, str,
bin, array and map. :func:`packb` gives the bytes of
``msgpack.packb(obj, use_bin_type=True)``: each int, str, bin, array and
map takes the smallest encoding that holds it, as msgpack picks it (the
frame writer re-packs a header and relies on its length staying put).
:func:`unpackb` reads what ``msgpack.unpackb(raw=False)`` reads: str as
``str``, bin as ``bytes``, arrays as lists, maps as dicts (any hashable
key), and float32 besides float64; ``copy_bin=False`` hands bin back as
zero-copy ``memoryview`` slices of the input. :func:`map_header` and
:func:`bin_header` let a writer lay out a large map of bins (a params
blob) straight into a buffer of its own.
"""

import struct
from typing import Any, Tuple

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_d = struct.Struct(">d")
_f = struct.Struct(">f")


def _pack_int(n: int, out: bytearray) -> None:
    if n >= 0:
        if n < 0x80:
            out.append(n)
        elif n <= 0xFF:
            out += b"\xcc" + _B.pack(n)
        elif n <= 0xFFFF:
            out += b"\xcd" + _H.pack(n)
        elif n <= 0xFFFFFFFF:
            out += b"\xce" + _I.pack(n)
        elif n <= 0xFFFFFFFFFFFFFFFF:
            out += b"\xcf" + _Q.pack(n)
        else:
            raise OverflowError(f"int {n} does not fit msgpack")
    elif n >= -32:
        out.append(n & 0xFF)
    elif n >= -0x80:
        out += b"\xd0" + _b.pack(n)
    elif n >= -0x8000:
        out += b"\xd1" + _h.pack(n)
    elif n >= -0x80000000:
        out += b"\xd2" + _i.pack(n)
    elif n >= -0x8000000000000000:
        out += b"\xd3" + _q.pack(n)
    else:
        raise OverflowError(f"int {n} does not fit msgpack")


def _pack_len(n: int, fix_base: int, fix_max: int, codes: bytes,
              out: bytearray) -> None:
    """Header of a str/bin/array/map of ``n`` items: the fix form when
    ``fix_base`` is set and ``n < fix_max``, else 8/16/32-bit lengths
    (``codes`` holds the 8-, 16- and 32-bit type bytes; 0 = no 8-bit)."""
    if fix_base and n < fix_max:
        out.append(fix_base | n)
    elif codes[0] and n <= 0xFF:
        out += bytes((codes[0],)) + _B.pack(n)
    elif n <= 0xFFFF:
        out += bytes((codes[1],)) + _H.pack(n)
    elif n <= 0xFFFFFFFF:
        out += bytes((codes[2],)) + _I.pack(n)
    else:
        raise ValueError("object too large for msgpack")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out += b"\xcb" + _d.pack(obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, b"\xd9\xda\xdb", out)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = memoryview(obj).cast("B")
        _pack_len(data.nbytes, 0, 0, b"\xc4\xc5\xc6", out)
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, b"\x00\xdc\xdd", out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, b"\x00\xde\xdf", out)
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def map_header(n: int) -> bytes:
    """The header of a map of ``n`` pairs, as :func:`packb` writes it."""
    out = bytearray()
    _pack_len(n, 0x80, 16, b"\x00\xde\xdf", out)
    return bytes(out)


def bin_header(n: int) -> bytes:
    """The header of a bin of ``n`` bytes, as :func:`packb` writes it."""
    out = bytearray()
    _pack_len(n, 0, 0, b"\xc4\xc5\xc6", out)
    return bytes(out)


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the supported types."""
    return bytes(pack_buffer(obj))


def pack_buffer(obj: Any) -> bytearray:
    """:func:`packb`'s bytes in the buffer they were packed into (a large
    bin is not copied a second time)."""
    out = bytearray()
    _pack(obj, out)
    return out


def pack_parts(obj: Any, min_bin: int = 1 << 20) -> list:
    """:func:`packb`'s bytes as a list of buffers whose concatenation they
    are: each bin of at least ``min_bin`` bytes is its own part, the
    object's memory, not copied (a writer sends the parts in order)."""
    parts = [bytearray()]

    def walk(o):
        if isinstance(o, (bytes, bytearray, memoryview)):
            data = memoryview(o).cast("B")
            if data.nbytes >= min_bin:
                _pack_len(data.nbytes, 0, 0, b"\xc4\xc5\xc6", parts[-1])
                parts.extend((data, bytearray()))
                return
        if isinstance(o, dict):
            _pack_len(len(o), 0x80, 16, b"\x00\xde\xdf", parts[-1])
            for key, value in o.items():
                walk(key)
                walk(value)
        elif isinstance(o, (list, tuple)):
            _pack_len(len(o), 0x90, 16, b"\x00\xdc\xdd", parts[-1])
            for item in o:
                walk(item)
        else:
            _pack(o, parts[-1])

    walk(obj)
    return [part for part in parts if len(part)]


_SIZED = {  # type byte → (struct of its length, kind)
    0xD9: (_B, "str"), 0xDA: (_H, "str"), 0xDB: (_I, "str"),
    0xC4: (_B, "bin"), 0xC5: (_H, "bin"), 0xC6: (_I, "bin"),
    0xDC: (_H, "array"), 0xDD: (_I, "array"),
    0xDE: (_H, "map"), 0xDF: (_I, "map"),
}
_NUMBERS = {
    0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q,
    0xD0: _b, 0xD1: _h, 0xD2: _i, 0xD3: _q,
    0xCA: _f, 0xCB: _d,
}


def _unpack(buf, pos: int, copy_bin: bool = True) -> Tuple[Any, int]:
    code = buf[pos]
    pos += 1
    if code <= 0x7F:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if 0xA0 <= code <= 0xBF:
        return _sized("str", code & 0x1F, buf, pos, copy_bin)
    if 0x90 <= code <= 0x9F:
        return _sized("array", code & 0x0F, buf, pos, copy_bin)
    if 0x80 <= code <= 0x8F:
        return _sized("map", code & 0x0F, buf, pos, copy_bin)
    if code == 0xC0:
        return None, pos
    if code == 0xC2:
        return False, pos
    if code == 0xC3:
        return True, pos
    number = _NUMBERS.get(code)
    if number is not None:
        return number.unpack_from(buf, pos)[0], pos + number.size
    sized = _SIZED.get(code)
    if sized is not None:
        length, kind = sized
        n = length.unpack_from(buf, pos)[0]
        return _sized(kind, n, buf, pos + length.size, copy_bin)
    raise ValueError(f"unsupported msgpack type byte 0x{code:02x}")


def _sized(kind: str, n: int, buf, pos: int,
           copy_bin: bool) -> Tuple[Any, int]:
    if kind == "str":
        end = pos + n
        if end > len(buf):
            raise ValueError("truncated msgpack str")
        return bytes(buf[pos:end]).decode("utf-8"), end
    if kind == "bin":
        end = pos + n
        if end > len(buf):
            raise ValueError("truncated msgpack bin")
        return (bytes(buf[pos:end]) if copy_bin else buf[pos:end]), end
    if kind == "array":
        items = []
        for _ in range(n):
            item, pos = _unpack(buf, pos, copy_bin)
            items.append(item)
        return items, pos
    out = {}
    for _ in range(n):
        key, pos = _unpack(buf, pos, copy_bin)
        value, pos = _unpack(buf, pos, copy_bin)
        out[key] = value
    return out, pos


def unpackb(data, copy_bin: bool = True) -> Any:
    """``msgpack.unpackb(data, raw=False)`` for the supported types; extra
    bytes after the object raise, as msgpack's do. With ``copy_bin=False``
    each bin is a ``memoryview`` into ``data``."""
    buf = memoryview(data).cast("B")
    try:
        obj, pos = _unpack(buf, 0, copy_bin)
    except (IndexError, struct.error) as e:
        raise ValueError(f"truncated msgpack data: {e}") from None
    if pos != len(buf):
        raise ValueError(f"extra data after msgpack object at {pos}")
    return obj
