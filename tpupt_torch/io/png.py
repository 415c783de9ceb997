"""PNG reader on the standard library and numpy.

Decodes 8-bit grey, grey+alpha, RGB and RGBA images, grey at 1, 2 and 4 bits, and
palette images at 1, 2, 4 and 8 bits, through all five row filters, to uint8
[H,W,3] as PIL's ``Image.open(path).convert("RGB")`` does: alpha is dropped, grey
is replicated (low bit depths scaled to 0..255), palette indices are expanded.
Adam7 interlacing and 16-bit samples raise ValueError; they are not read.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# colour type -> (samples a pixel, allowed bit depths)
_COLOUR_TYPES = {0: (1, (1, 2, 4, 8)), 2: (3, (8,)), 3: (1, (1, 2, 4, 8)), 4: (2, (8,)), 6: (4, (8,))}


def _chunks(data: bytes, path: str):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"{path}: truncated PNG chunk {tag!r}")
        yield tag, body
        if tag == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: PNG ends without an IEND chunk")


def _paeth_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    """Undo the Paeth filter in place (PNG spec, 9.4: ties go to a, then b)."""
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _unfilter(raw: bytes, h: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """The filtered scanlines (a filter byte before each) -> uint8 [h, stride]."""
    if len(raw) < h * (stride + 1):
        raise ValueError(f"{path}: PNG image data is {len(raw)} bytes, need {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8, count=h * (stride + 1)).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, cur = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            row = cur.copy()
        elif ftype == 1:  # Sub: a running sum over each byte lane of the pixel
            lanes = np.zeros(-(-stride // bpp) * bpp, np.uint8)
            lanes[:stride] = cur
            row = np.cumsum(lanes.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)[:stride]
        elif ftype == 2:  # Up
            row = cur + prev
        elif ftype == 3:  # Average: floor((left + up) / 2), left already decoded
            buf, up = bytearray(cur.tobytes()), prev.tobytes()
            for i in range(stride):
                left = buf[i - bpp] if i >= bpp else 0
                buf[i] = (buf[i] + ((left + up[i]) >> 1)) & 0xFF
            row = np.frombuffer(bytes(buf), np.uint8)
        elif ftype == 4:
            buf = bytearray(cur.tobytes())
            _paeth_row(buf, prev.tobytes(), bpp)
            row = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"{path}: PNG row {y} has unknown filter type {ftype}")
        out[y] = row
        prev = out[y]
    return out


def read_png_rgb8(path: str) -> np.ndarray:
    """Decode a PNG file -> uint8 [H,W,3] (PIL's ``.convert("RGB")``)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    ihdr, palette, idat = None, None, []
    for tag, body in _chunks(data, path):
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body[:13])
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"{path}: PNG has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if interlace:
        raise ValueError(f"{path}: Adam7-interlaced PNG is not supported")
    if depth == 16:
        raise ValueError(f"{path}: 16-bit PNG samples are not supported")
    if ctype not in _COLOUR_TYPES or depth not in _COLOUR_TYPES[ctype][1]:
        raise ValueError(f"{path}: PNG colour type {ctype} at {depth} bits is not supported")
    channels = _COLOUR_TYPES[ctype][0]
    stride = -(-w * channels * depth // 8)
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, stride, max(1, channels * depth // 8), path)

    if depth < 8:  # packed samples, most significant bits first
        bits = np.unpackbits(rows, axis=1).reshape(h, stride * 8 // depth, depth)[:, :w]
        samples = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(axis=2, dtype=np.uint8)
    else:
        samples = rows.reshape(h, w, channels)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG has no PLTE chunk")
        if int(samples.max(initial=0)) >= palette.shape[0]:
            raise ValueError(f"{path}: PNG palette index beyond its {palette.shape[0]} entries")
        return palette[samples.reshape(h, w)]
    if ctype == 0:
        grey = samples.reshape(h, w)
        if depth < 8:
            grey = (grey.astype(np.uint16) * 255 // ((1 << depth) - 1)).astype(np.uint8)
        return np.repeat(grey[..., None], 3, axis=2)
    if ctype == 4:
        return np.repeat(samples[..., :1], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])
