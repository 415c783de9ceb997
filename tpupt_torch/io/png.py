"""PNG reader on the standard library and numpy.

Decodes grey at 1, 2, 4, 8 and 16 bits, palette images at 1, 2, 4 and 8 bits, and
grey+alpha, RGB and RGBA at 8 and 16 bits, through all five row filters, plain or
Adam7-interlaced, to uint8 [H,W,3] as PIL's ``Image.open(path).convert("RGB")``
does: alpha is dropped, grey is replicated (low bit depths scaled to 0..255),
palette indices are expanded, and a 16-bit sample gives its high byte, except
16-bit grey, which PIL opens as mode I;16 and clips at 255 (see _to_rgb8).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# colour type -> (samples a pixel, allowed bit depths)
_COLOUR_TYPES = {
    0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16)),
}
# Adam7's seven passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


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


def _unfilter(raw: bytes, offset: int, h: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """The h filtered scanlines at raw[offset:] (a filter byte before each) -> uint8 [h, stride]."""
    if len(raw) < offset + h * (stride + 1):
        raise ValueError(f"{path}: PNG image data is {len(raw)} bytes, need {offset + h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8, count=h * (stride + 1), offset=offset).reshape(h, stride + 1)
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


def _samples(rows: np.ndarray, w: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered rows uint8 [h, stride] -> samples [h, w, channels] (uint8, or uint16 at 16
    bits, big-endian in the file); packed samples come most significant bits first."""
    h, stride = rows.shape
    if depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(h, stride * 8 // depth, depth)[:, :w]
        return (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(axis=2, dtype=np.uint8)[..., None]
    if depth == 16:
        pairs = rows.reshape(h, w, channels, 2).astype(np.uint16)
        return (pairs[..., 0] << 8) | pairs[..., 1]
    return rows.reshape(h, w, channels)


def _to_rgb8(samples: np.ndarray, ctype: int, depth: int, palette, path: str) -> np.ndarray:
    """Samples [h, w, channels] -> uint8 [h, w, 3], as PIL's convert("RGB")."""
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG has no PLTE chunk")
        if int(samples.max(initial=0)) >= palette.shape[0]:
            raise ValueError(f"{path}: PNG palette index beyond its {palette.shape[0]} entries")
        return palette[samples[..., 0]]
    if depth == 16 and ctype == 0:
        # PIL opens 16-bit grey as mode I;16, whose conversion to RGB clips each sample
        # at 255 (7 -> 7, 4007 -> 255) instead of taking its high byte as it does for
        # the other colour types. The reference reads textures through PIL, so this is
        # the reference's texture; do not "fix" it.
        samples = np.minimum(samples, 255).astype(np.uint8)
    elif depth == 16:
        samples = (samples >> 8).astype(np.uint8)
    elif depth < 8:  # grey at 1, 2 or 4 bits, scaled to 0..255
        samples = (samples.astype(np.uint16) * 255 // ((1 << depth) - 1)).astype(np.uint8)
    if ctype in (0, 4):
        return np.repeat(samples[..., :1], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])


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
    if ctype not in _COLOUR_TYPES or depth not in _COLOUR_TYPES[ctype][1]:
        raise ValueError(f"{path}: PNG colour type {ctype} at {depth} bits is not supported")
    if interlace not in (0, 1):
        raise ValueError(f"{path}: PNG interlace method {interlace} is not supported")
    channels = _COLOUR_TYPES[ctype][0]
    bpp = max(1, channels * depth // 8)
    raw = zlib.decompress(b"".join(idat))
    if not interlace:
        stride = -(-w * channels * depth // 8)
        samples = _samples(_unfilter(raw, 0, h, stride, bpp, path), w, channels, depth)
    else:  # Adam7: each pass is an image of its own, filtered row by row; empty ones take no bytes
        samples = np.zeros((h, w, 1 if depth < 8 else channels), np.uint16 if depth == 16 else np.uint8)
        offset = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue
            stride = -(-pw * channels * depth // 8)
            rows = _unfilter(raw, offset, ph, stride, bpp, path)
            samples[y0::dy, x0::dx] = _samples(rows, pw, channels, depth)
            offset += ph * (stride + 1)
    return _to_rgb8(samples, ctype, depth, palette, path)
