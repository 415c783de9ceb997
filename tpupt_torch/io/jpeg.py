"""JPEG reader on the standard library and numpy.

Decodes sequential (SOF0/SOF1) and progressive (SOF2) Huffman-coded JPEG at 8-bit
precision with 1 or 3 components, chroma sampled 4:4:4, 4:2:2 (h2v1) or 4:2:0
(h2v2), with or without restart markers, to uint8 [H,W,3]. It computes what PIL's
libjpeg(-turbo) computes by default, so a texture decodes to the same bytes as
under the reference package:

- the progressive scans of ITU T.81 G.1.2 (jdphuff.c: DC first and refinement, AC
  first with end-of-band runs, AC refinement) into the coefficient store that the
  sequential scans fill, each component's quantization table latched at its first
  scan (jdinput.c);

- the ISLOW integer IDCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2, and the
  post-IDCT range-limit table, which wraps at 1024);
- "fancy" triangle upsampling (jdsample.c h2v1 / h2v2, the first and last column
  and the rows above the top and below the bottom replicated);
- integer YCbCr -> RGB through jdcolor.c's tables (SCALEBITS 16).

The Huffman decode is a Python loop over a table of 16-bit lookahead windows; the
IDCT, the upsampling and the colour conversion run in numpy over all blocks at
once. Lossless, hierarchical and arithmetic-coded files, 12-bit samples and CMYK
raise ValueError naming the file, and so does a progressive file whose scans leave
a low-frequency coefficient unrefined: libjpeg smooths such blocks
(jdcoefct.c decompress_smooth_data), which this reader does not do.
"""

from __future__ import annotations

import array
import struct

import numpy as np

# zig-zag position -> natural (row-major) index, with libjpeg's 16 safety entries
_NATURAL = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
] + [63] * 16

_UNSUPPORTED_SOF = {
    0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical",
    0xC7: "hierarchical", 0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
    0xCE: "arithmetic-coded hierarchical", 0xCF: "arithmetic-coded hierarchical",
}


def _huffman_lut(counts, symbols, path):
    """A canonical Huffman table -> list of 65536 entries (symbol << 5 | code length),
    indexed by the next 16 bits of the stream; 0 marks a bit pattern with no code."""
    if len(counts) != 16 or len(symbols) != sum(counts):
        raise ValueError(f"{path}: JPEG Huffman table is truncated")
    lut = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise ValueError(f"{path}: JPEG Huffman table is over-subscribed")
            lo = code << (16 - length)
            lut[lo : lo + (1 << (16 - length))] = (symbols[k] << 5) | length
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _entropy_segments(data: bytes, pos: int, path: str):
    """Unstuff the entropy-coded data from `pos` -> (bytes, start byte of each restart
    segment, position of the marker that ends the scan)."""
    out, starts = bytearray(), [0]
    while True:
        j = data.find(b"\xff", pos)
        if j < 0 or j + 1 >= len(data):
            raise ValueError(f"{path}: JPEG scan data ends without a marker")
        out += data[pos:j]
        nxt = data[j + 1]
        if nxt == 0x00:  # a stuffed 0xFF data byte
            out.append(0xFF)
            pos = j + 2
        elif nxt == 0xFF:  # fill byte before a marker
            pos = j + 1
        elif 0xD0 <= nxt <= 0xD7:  # RSTn: the next restart interval starts byte-aligned
            starts.append(len(out))
            pos = j + 2
        else:
            return bytes(out), starts, j


def _windows(stream: bytes):
    """The 16 bits that start at every bit position of `stream` (zeros past its end)."""
    b = np.frombuffer(stream + b"\x00\x00\x00", np.uint8).astype(np.uint32)
    w24 = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
    p = np.arange(8 * len(stream) + 1, dtype=np.int64)
    win = (w24[p >> 3] >> (8 - (p & 7)).astype(np.uint32)) & 0xFFFF
    return array.array("H", win.astype(np.uint16).tobytes())


def _decode_scan(stream, starts, scan, blocks, restart, path):
    """Huffman-decode one scan into the quantized coefficient store `blocks`.

    scan: (mcu_blocks, MCU count), mcu_blocks(m) listing (component, dc lut, ac lut,
    offset in `blocks`) for each block of MCU m; a block's coefficient at natural
    index i lands in blocks[offset + i]. restart: the MCUs between restart markers
    (0: none); starts: the byte where each restart interval begins in `stream`."""
    win = _windows(stream)
    end = 8 * len(stream)
    mcu_blocks, n_mcu = scan
    pred = {}
    pos, seg = 0, 0
    for m in range(n_mcu):
        if restart and m and m % restart == 0:
            seg += 1
            if seg >= len(starts):
                raise ValueError(f"{path}: JPEG restart marker missing before MCU {m}")
            pos = 8 * starts[seg]
            pred.clear()
        for comp, dc, ac, base in mcu_blocks(m):
            e = dc[win[pos]]
            if not e:
                raise ValueError(f"{path}: bad JPEG Huffman code at bit {pos}")
            pos += e & 31
            s = e >> 5
            v = 0
            if s:
                v = win[pos] >> (16 - s)
                pos += s
                if v < 1 << (s - 1):
                    v -= (1 << s) - 1
            v += pred.get(comp, 0)
            pred[comp] = v
            blocks[base] = v
            k = 1
            while k < 64:
                e = ac[win[pos]]
                if not e:
                    raise ValueError(f"{path}: bad JPEG Huffman code at bit {pos}")
                pos += e & 31
                rs = e >> 5
                s = rs & 15
                if s:
                    k += rs >> 4
                    v = win[pos] >> (16 - s)
                    pos += s
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                    blocks[base + _NATURAL[k]] = v
                    k += 1
                elif rs == 0xF0:  # ZRL: sixteen zeros
                    k += 16
                else:  # EOB
                    break
        if pos > end:
            raise ValueError(f"{path}: JPEG scan data is truncated")


def _refine(blocks, i, bit, p1):
    """A refinement scan's correction bit on a coefficient with a non-zero history: 1
    raises its magnitude by p1 (jdphuff.c; that bit is still 0, since the scan before
    coded the coefficient in multiples of 2 p1, as _check_progression holds)."""
    if bit:
        c = blocks[i]
        blocks[i] = c + p1 if c >= 0 else c - p1


def _decode_progressive_scan(stream, starts, scan, blocks, restart, band, path):
    """Huffman-decode one progressive scan (jdphuff.c) into the coefficient store.

    band: (Ss, Se, Ah, Al). Ss = 0 is a DC scan (first if Ah = 0: the difference to
    the component's predictor, shifted up by Al; else one bit ORed in at Al), Ss > 0 an
    AC scan of coefficients Ss..Se of one component (first if Ah = 0: values shifted
    up by Al, with runs of blocks that end here, EOBRUN; else a correction bit for
    each coefficient with a non-zero history and new coefficients of +-2^Al). The
    predictors and EOBRUN restart at every restart marker. Arguments as _decode_scan.
    """
    ss, se, ah, al = band
    win = _windows(stream)
    end = 8 * len(stream)
    mcu_blocks, n_mcu = scan
    pred = {}
    pos, seg, eobrun = 0, 0, 0
    p1 = 1 << al
    for m in range(n_mcu):
        if restart and m and m % restart == 0:
            seg += 1
            if seg >= len(starts):
                raise ValueError(f"{path}: JPEG restart marker missing before MCU {m}")
            pos = 8 * starts[seg]
            pred.clear()
            eobrun = 0
        for comp, dc, ac, base in mcu_blocks(m):
            if ss == 0 and ah == 0:  # DC first
                e = dc[win[pos]]
                if not e:
                    raise ValueError(f"{path}: bad JPEG Huffman code at bit {pos}")
                pos += e & 31
                s = e >> 5
                v = 0
                if s:
                    v = win[pos] >> (16 - s)
                    pos += s
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                v += pred.get(comp, 0)
                pred[comp] = v
                blocks[base] = v * p1
            elif ss == 0:  # DC refinement
                if win[pos] >> 15:
                    blocks[base] |= p1
                pos += 1
            elif ah == 0:  # AC first
                if eobrun:
                    eobrun -= 1
                    continue
                k = ss
                while k <= se:
                    e = ac[win[pos]]
                    if not e:
                        raise ValueError(f"{path}: bad JPEG Huffman code at bit {pos}")
                    pos += e & 31
                    r, s = e >> 9, (e >> 5) & 15
                    if s:
                        k += r
                        v = win[pos] >> (16 - s)
                        pos += s
                        if v < 1 << (s - 1):
                            v -= (1 << s) - 1
                        blocks[base + _NATURAL[k]] = v * p1
                    elif r == 15:  # ZRL: sixteen zeros
                        k += 15
                    else:  # EOBr: this block and 2^r - 1 + (r bits) more end here
                        eobrun = 1 << r
                        if r:
                            eobrun += win[pos] >> (16 - r)
                            pos += r
                        eobrun -= 1
                        break
                    k += 1
            else:  # AC refinement
                k = ss
                if not eobrun:
                    while k <= se:
                        e = ac[win[pos]]
                        if not e:
                            raise ValueError(f"{path}: bad JPEG Huffman code at bit {pos}")
                        pos += e & 31
                        r, s = e >> 9, (e >> 5) & 15
                        new = 0
                        if s:  # a new coefficient of magnitude 2^Al, its sign bit next
                            new = p1 if win[pos] >> 15 else -p1
                            pos += 1
                        elif r != 15:  # EOBr: the rest of this band in the run below
                            eobrun = 1 << r
                            if r:
                                eobrun += win[pos] >> (16 - r)
                                pos += r
                            break
                        # pass r zero-history coefficients (ZRL: 15, and the loop's
                        # step the 16th), a correction bit for each non-zero one
                        while k <= se:
                            i = base + _NATURAL[k]
                            if blocks[i]:
                                _refine(blocks, i, win[pos] >> 15, p1)
                                pos += 1
                            else:
                                r -= 1
                                if r < 0:
                                    break
                            k += 1
                        if new:
                            blocks[base + _NATURAL[k]] = new
                        k += 1
                if eobrun:  # in an end-of-band run: correction bits only
                    while k <= se:
                        i = base + _NATURAL[k]
                        if blocks[i]:
                            _refine(blocks, i, win[pos] >> 15, p1)
                            pos += 1
                        k += 1
                    eobrun -= 1
        if pos > end:
            raise ValueError(f"{path}: JPEG scan data is truncated")


# ---- ISLOW IDCT (jidctint.c) ----

CONST_BITS, PASS1_BITS = 13, 2


def _fix(x):
    return int(x * (1 << CONST_BITS) + 0.5)


F_0_298, F_0_390, F_0_541, F_0_765 = _fix(0.298631336), _fix(0.390180644), _fix(0.541196100), _fix(0.765366865)
F_0_899, F_1_175, F_1_501, F_1_847 = _fix(0.899976223), _fix(1.175875602), _fix(1.501321110), _fix(1.847759065)
F_1_961, F_2_053, F_2_562, F_3_072 = _fix(1.961570560), _fix(2.053119869), _fix(2.562915447), _fix(3.072711026)


def _idct_1d(s, shift):
    """One 8-point ISLOW pass over the first axis of s (8, ...) int64 -> descaled (8, ...)."""
    z2, z3 = s[2], s[6]
    z1 = (z2 + z3) * F_0_541
    tmp2 = z1 + z3 * -F_1_847
    tmp3 = z1 + z2 * F_0_765
    tmp0 = (s[0] + s[4]) << CONST_BITS
    tmp1 = (s[0] - s[4]) << CONST_BITS
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = s[7], s[5], s[3], s[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * F_1_175
    t0, t1, t2, t3 = t0 * F_0_298, t1 * F_2_053, t2 * F_3_072, t3 * F_1_501
    z1, z2 = z1 * -F_0_899, z2 * -F_2_562
    z3, z4 = z3 * -F_1_961 + z5, z4 * -F_0_390 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    half = 1 << (shift - 1)
    return np.stack([
        (tmp10 + t3 + half) >> shift, (tmp11 + t2 + half) >> shift,
        (tmp12 + t1 + half) >> shift, (tmp13 + t0 + half) >> shift,
        (tmp13 - t0 + half) >> shift, (tmp12 - t1 + half) >> shift,
        (tmp11 - t2 + half) >> shift, (tmp10 - t3 + half) >> shift,
    ])


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantized coefficients [N,8,8] (row = vertical frequency) -> samples uint8 [N,8,8]."""
    c = np.moveaxis(coef.astype(np.int64), (1, 2), (0, 1))  # [v, u, N]
    ws = _idct_1d(c, CONST_BITS - PASS1_BITS)  # columns: [y, u, N]
    out = _idct_1d(np.moveaxis(ws, 1, 0), CONST_BITS + PASS1_BITS + 3)  # rows: [x, y, N]
    # the post-IDCT range limit: index & 1023, centred on 128, clamped, wrapping at +-512
    v = ((out + 512) & 1023) - 512 + 128
    return np.moveaxis(np.clip(v, 0, 255).astype(np.uint8), (0, 1, 2), (2, 1, 0))


# ---- upsampling (jdsample.c) and colour conversion (jdcolor.c) ----


def _upsample_h2(p: np.ndarray) -> np.ndarray:
    """h2v1 fancy upsampling of uint8 rows [h, w] -> [h, 2w]."""
    if p.shape[1] <= 2:  # libjpeg takes plain replication below 3 columns
        return np.repeat(p, 2, axis=1)
    x = p.astype(np.int32)
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    return out.astype(np.uint8)


def _upsample_h2v2(p: np.ndarray) -> np.ndarray:
    """h2v2 fancy upsampling of uint8 [h, w] -> [2h, 2w]."""
    if p.shape[1] <= 2:  # libjpeg takes plain replication below 3 columns
        return np.repeat(np.repeat(p, 2, axis=0), 2, axis=1)
    x = p.astype(np.int32)
    above = np.concatenate([x[:1], x[:-1]], axis=0)
    below = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int32)
    for v, near in ((0, above), (1, below)):
        col = 3 * x + near  # column sums
        last = np.concatenate([col[:, :1], col[:, :-1]], axis=1)
        nxt = np.concatenate([col[:, 1:], col[:, -1:]], axis=1)
        out[v::2, 0::2] = (3 * col + last + 8) >> 4
        out[v::2, 1::2] = (3 * col + nxt + 7) >> 4
    return out.astype(np.uint8)


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's integer YCbCr -> RGB of uint8 planes -> uint8 [H,W,3]."""
    cr_r, cb_b, cr_g, cb_g = _ycc_tables()
    yy = y.astype(np.int64)
    r = yy + cr_r[cr]
    g = yy + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = yy + cb_b[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# ---- the file ----


class _Frame:
    """Block layout of a frame: per component its block grid (padded to whole MCUs)
    and its offset in the coefficient store, and the plane size before upsampling."""

    def __init__(self, w, h, comps, path):
        self.w, self.h, self.comps = w, h, comps
        self.hmax = max(c["h"] for c in comps)
        self.vmax = max(c["v"] for c in comps)
        self.mcux = -(-w // (8 * self.hmax))
        self.mcuy = -(-h // (8 * self.vmax))
        off = 0
        for c in comps:
            if (self.hmax // c["h"], self.vmax // c["v"]) not in ((1, 1), (2, 1), (2, 2)) or (
                self.hmax % c["h"] or self.vmax % c["v"]
            ):
                raise ValueError(
                    f"{path}: JPEG sampling factors "
                    f"{[(k['h'], k['v']) for k in comps]} are not supported"
                )
            c["bw"], c["bh"] = self.mcux * c["h"], self.mcuy * c["v"]
            c["cw"] = -(-w * c["h"] // self.hmax)
            c["ch"] = -(-h * c["v"] // self.vmax)
            c["off"] = off
            off += 64 * c["bw"] * c["bh"]
        self.n_coefs = off
        self.path = path

    def index(self, cid):
        for i, c in enumerate(self.comps):
            if c["id"] == cid:
                return i
        raise ValueError(f"{self.path}: JPEG scan names an unknown component {cid}")

    def scan(self, members):
        """-> (mcu_blocks(m) -> [(component, dc, ac, store offset)], MCU count)."""
        if len(members) == 1:  # non-interleaved: one block an MCU, over the plane's blocks
            ci, dc, ac = members[0]
            c = self.comps[ci]
            nbx, nby = -(-c["cw"] // 8), -(-c["ch"] // 8)
            return (lambda m: [(ci, dc, ac, c["off"] + 64 * ((m // nbx) * c["bw"] + m % nbx))]), nbx * nby
        rel = []
        for ci, dc, ac in members:
            c = self.comps[ci]
            for v in range(c["v"]):
                for hh in range(c["h"]):
                    rel.append((ci, dc, ac, c["off"], c["v"], c["h"], c["bw"], v * c["bw"] + hh))
        mcux = self.mcux

        def mcu_blocks(m):  # block (my*V + v, mx*H + h) of each component, in scan order
            my, mx = divmod(m, mcux)
            return [(ci, dc, ac, off + 64 * (my * vf * bw + mx * hf + r))
                    for ci, dc, ac, off, vf, hf, bw, r in rel]

        return mcu_blocks, self.mcux * self.mcuy


def _plane(frame, c, store, qt):
    """A component's samples, cropped to its plane and upsampled to the image -> uint8 [H,W]."""
    coef = np.frombuffer(store, np.int32)[c["off"] : c["off"] + 64 * c["bw"] * c["bh"]]
    coef = coef.reshape(-1, 64).astype(np.int64) * qt
    blocks = idct_islow(coef.reshape(-1, 8, 8)).reshape(c["bh"], c["bw"], 8, 8)
    p = blocks.transpose(0, 2, 1, 3).reshape(8 * c["bh"], 8 * c["bw"])[: c["ch"], : c["cw"]]
    ratio = (frame.hmax // c["h"], frame.vmax // c["v"])
    if ratio == (2, 1):
        p = _upsample_h2(p)
    elif ratio == (2, 2):
        p = _upsample_h2v2(p)
    return p[: frame.h, : frame.w]


def _check_progression(band, comps, coef_bits, path):
    """Refuse a progressive scan that libjpeg refuses or warns about (jdphuff.c
    start_pass_phuff_decoder), and record its Al for each coefficient it codes."""
    ss, se, ah, al = band
    bad = (se != 0) if ss == 0 else (ss > se or se > 63 or len(comps) != 1)
    if bad or (ah and al != ah - 1) or al > 13:
        raise ValueError(f"{path}: progressive JPEG scan with Ss={ss} Se={se} Ah={ah} Al={al} is invalid")
    for ci in comps:
        bits = coef_bits[ci]
        if (ss > 0 and bits[0] < 0) or any(ah != max(bits[k], 0) for k in range(ss, se + 1)):
            raise ValueError(f"{path}: progressive JPEG scans out of order (component {ci}, Ss={ss}, Ah={ah})")
        bits[ss : se + 1] = [al] * (se - ss + 1)


# natural positions of the DC and first nine AC coefficients (jdcoefct.c Q00_POS..Q30_POS)
_SMOOTHED = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24)


def _would_smooth(coef_bits, comp_qt):
    """libjpeg's smoothing_ok (jdcoefct.c, libjpeg-turbo 2.1 and later): block smoothing
    runs when every component has its DC and those nine quantizers non-zero and a DC
    scan, and some component's first nine AC coefficients are not fully refined."""
    ok = all(bits[0] >= 0 and all(comp_qt[ci][k] for k in _SMOOTHED) for ci, bits in enumerate(coef_bits))
    return ok and any(bits[k] != 0 for bits in coef_bits for k in range(1, 10))


def read_jpeg_rgb8(path: str) -> np.ndarray:
    """Decode a baseline or progressive JPEG file -> uint8 [H,W,3] (PIL's ``.convert("RGB")``)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"\xff\xd8"):
        raise ValueError(f"{path}: not a JPEG file")
    qt, dc_tabs, ac_tabs, comp_qt = {}, {}, {}, {}
    frame = store = coef_bits = None
    restart, jfif, adobe_transform, progressive = 0, False, None, False
    pos = 2
    while True:
        while pos < len(data) and data[pos] == 0xFF:  # a marker and its fill bytes
            pos += 1
        if pos >= len(data) or data[pos - 1] != 0xFF:
            raise ValueError(f"{path}: JPEG marker expected at byte {pos}")
        marker = data[pos]
        if marker == 0xD9:  # EOI
            break
        if pos + 3 > len(data):
            raise ValueError(f"{path}: JPEG is truncated")
        (n,) = struct.unpack(">H", data[pos + 1 : pos + 3])
        if n < 2 or pos + 1 + n > len(data):
            raise ValueError(f"{path}: JPEG is truncated")
        body, pos = data[pos + 3 : pos + 1 + n], pos + 1 + n
        if marker in _UNSUPPORTED_SOF:
            raise ValueError(f"{path}: {_UNSUPPORTED_SOF[marker]} JPEG is not supported")
        if marker == 0xCC:
            raise ValueError(f"{path}: arithmetic-coded JPEG is not supported")
        if marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq:
                    vals, i = struct.unpack(">64H", body[i + 1 : i + 129]), i + 129
                else:
                    vals, i = tuple(body[i + 1 : i + 65]), i + 65
                qt[tq] = np.zeros(64, np.int64)
                qt[tq][_NATURAL[:64]] = vals
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc, th, counts = body[i] >> 4, body[i] & 15, body[i + 1 : i + 17]
                symbols = body[i + 17 : i + 17 + sum(counts)]
                (ac_tabs if tc else dc_tabs)[th] = _huffman_lut(counts, symbols, path)
                i += 17 + sum(counts)
        elif marker == 0xDD:  # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe_transform = body[11]
        elif marker in (0xC0, 0xC1, 0xC2):  # SOF0 / SOF1 / SOF2 (progressive)
            progressive = marker == 0xC2
            precision, h, w, nf = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise ValueError(f"{path}: {precision}-bit JPEG is not supported")
            if nf not in (1, 3):
                raise ValueError(f"{path}: JPEG with {nf} components (CMYK?) is not supported")
            if h == 0 or w == 0:
                raise ValueError(f"{path}: JPEG with a DNL-defined height is not supported")
            comps = [dict(id=body[6 + 3 * c], h=body[7 + 3 * c] >> 4, v=body[7 + 3 * c] & 15,
                          tq=body[8 + 3 * c]) for c in range(nf)]
            if nf == 1:  # a single component is always one block an MCU
                comps[0].update(h=1, v=1)
            frame = _Frame(w, h, comps, path)
            store = array.array("i", bytes(4 * frame.n_coefs))
            coef_bits = [[-1] * 64 for _ in comps]  # the Al of each coefficient's last scan
        elif marker == 0xDA:  # SOS: the entropy-coded data follows its header
            if frame is None:
                raise ValueError(f"{path}: JPEG scan before its frame header")
            ns = body[0]
            band = (body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns] >> 4, body[3 + 2 * ns] & 15)
            members = []
            for c in range(ns):
                ci, t = frame.index(body[1 + 2 * c]), body[2 + 2 * c]
                # a sequential scan reads both tables; a progressive DC scan the DC table
                # (its refinement none), an AC scan the AC table
                need_dc = not progressive or (band[0] == 0 and band[2] == 0)
                need_ac = not progressive or band[0] > 0
                if (need_dc and (t >> 4) not in dc_tabs) or (need_ac and (t & 15) not in ac_tabs):
                    raise ValueError(f"{path}: JPEG scan names a missing Huffman table")
                if frame.comps[ci]["tq"] not in qt:
                    raise ValueError(f"{path}: JPEG scan needs a missing quantization table")
                comp_qt.setdefault(ci, qt[frame.comps[ci]["tq"]].copy())
                members.append((ci, dc_tabs.get(t >> 4), ac_tabs.get(t & 15)))
            stream, starts, pos = _entropy_segments(data, pos, path)
            if progressive:
                _check_progression(band, [m[0] for m in members], coef_bits, path)
                _decode_progressive_scan(stream, starts, frame.scan(members), store, restart, band, path)
            else:
                _decode_scan(stream, starts, frame.scan(members), store, restart, path)
    if frame is None or len(comp_qt) != len(frame.comps):
        raise ValueError(f"{path}: JPEG ends before every component was scanned")
    if progressive and _would_smooth(coef_bits, comp_qt):
        raise ValueError(
            f"{path}: progressive JPEG whose scans leave low-frequency coefficients unrefined "
            "(libjpeg smooths such blocks; this reader does not) is not supported"
        )
    planes = [_plane(frame, c, store, comp_qt[i]) for i, c in enumerate(frame.comps)]
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    ids = tuple(c["id"] for c in frame.comps)
    rgb = (not jfif) and (adobe_transform == 0 or (adobe_transform is None and ids == (82, 71, 66)))
    return np.stack(planes, axis=-1) if rgb else ycc_to_rgb(*planes)
