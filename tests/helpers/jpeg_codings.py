"""Writers of the JPEG codings neither machine has an encoder for, in numpy
and Python, for the tests that hold the port's decoder to Pillow (whose
libjpeg-turbo decodes each file these write, and is the oracle):

* `read_baseline(data)`: the frame, quantization tables and quantized
  coefficients of a baseline Huffman file (Pillow's writer, no restarts);
* `coefficients(img, sampling, quality)`: the quantized coefficients of an
  RGB or grey image at any sampling factors (JFIF YCbCr, box-averaged
  chroma, a float DCT, IJG tables scaled to `quality`);
* `huffman_file(frame)`: a baseline file of those coefficients (the
  standard K.3 tables);
* `arithmetic_file(frame, progressive, restart, dac)`: SOF9 (sequential)
  or SOF10 (progressive: DC first and refinement, spectral selection and
  successive approximation) with the T.81 Annex D coder as libjpeg's
  jcarith.c runs it, restart intervals and DAC conditioning;
* `lossless_file(img, predictor, pt, precision)`: SOF3, any of the seven
  predictors and a point transform;
* `cut_scans(data, k)`: a progressive file with only its first k scans.

A frame is a dict: `w`, `h`, `comps` [(id, h, v, tq)], `qt` {tq: 64 natural-
order values}, `coef` [[by, bx, 64] natural-order int arrays per component],
`app` (the segments before the tables, kept as they are).
"""
from __future__ import annotations

import struct

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58,
    59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
DC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
DC_VALS = list(range(12))
AC_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d]
AC_VALS = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa]
LUMA_Q = [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57,
          69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55,
          64, 81, 104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100,
          103, 99]
CHROMA_Q = ([17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4 + [24, 26, 56] + [99] * 5
            + [47, 66] + [99] * 38)
JFIF = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
# T.81 Table D.2: (Qe, Next_Index_MPS, Next_Index_LPS, Switch_MPS)
ARITAB = [
    (0x5a1d, 1, 1, 1), (0x2586, 2, 14, 0), (0x1114, 3, 16, 0), (0x080b, 4, 18, 0),
    (0x03d8, 5, 20, 0), (0x01da, 6, 23, 0), (0x00e5, 7, 25, 0), (0x006f, 8, 28, 0),
    (0x0036, 9, 30, 0), (0x001a, 10, 33, 0), (0x000d, 11, 35, 0), (0x0006, 12, 9, 0),
    (0x0003, 13, 10, 0), (0x0001, 13, 12, 0), (0x5a7f, 15, 15, 1), (0x3f25, 16, 36, 0),
    (0x2cf2, 17, 38, 0), (0x207c, 18, 39, 0), (0x17b9, 19, 40, 0), (0x1182, 20, 42, 0),
    (0x0cef, 21, 43, 0), (0x09a1, 22, 45, 0), (0x072f, 23, 46, 0), (0x055c, 24, 48, 0),
    (0x0406, 25, 49, 0), (0x0303, 26, 51, 0), (0x0240, 27, 52, 0), (0x01b1, 28, 54, 0),
    (0x0144, 29, 56, 0), (0x00f5, 30, 57, 0), (0x00b7, 31, 59, 0), (0x008a, 32, 60, 0),
    (0x0068, 33, 62, 0), (0x004e, 34, 63, 0), (0x003b, 35, 32, 0), (0x002c, 9, 33, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 38, 64, 0), (0x3a0d, 39, 65, 0), (0x2ef1, 40, 67, 0),
    (0x261f, 41, 68, 0), (0x1f33, 42, 69, 0), (0x19a8, 43, 70, 0), (0x1518, 44, 72, 0),
    (0x1177, 45, 73, 0), (0x0e74, 46, 74, 0), (0x0bfb, 47, 75, 0), (0x09f8, 48, 77, 0),
    (0x0861, 49, 78, 0), (0x0706, 50, 79, 0), (0x05cd, 51, 48, 0), (0x04de, 52, 50, 0),
    (0x040f, 53, 50, 0), (0x0363, 54, 51, 0), (0x02d4, 55, 52, 0), (0x025c, 56, 53, 0),
    (0x01f8, 57, 54, 0), (0x01a4, 58, 55, 0), (0x0160, 59, 56, 0), (0x0125, 60, 57, 0),
    (0x00f6, 61, 58, 0), (0x00cb, 62, 59, 0), (0x00ab, 63, 61, 0), (0x008f, 32, 61, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 66, 80, 0), (0x412c, 67, 81, 0), (0x37d8, 68, 82, 0),
    (0x2fe8, 69, 83, 0), (0x293c, 70, 84, 0), (0x2379, 71, 86, 0), (0x1edf, 72, 87, 0),
    (0x1aa9, 73, 87, 0), (0x174e, 74, 72, 0), (0x1424, 75, 72, 0), (0x119c, 76, 74, 0),
    (0x0f6b, 77, 74, 0), (0x0d51, 78, 75, 0), (0x0bb6, 79, 77, 0), (0x0a40, 48, 77, 0),
    (0x5832, 81, 80, 1), (0x4d1c, 82, 88, 0), (0x438e, 83, 89, 0), (0x3bdd, 84, 90, 0),
    (0x34ee, 85, 91, 0), (0x2eae, 86, 92, 0), (0x299a, 87, 93, 0), (0x2516, 71, 86, 0),
    (0x5570, 89, 88, 1), (0x4ca9, 90, 95, 0), (0x44d9, 91, 96, 0), (0x3e22, 92, 97, 0),
    (0x3824, 93, 99, 0), (0x32b4, 94, 99, 0), (0x2e17, 86, 93, 0), (0x56a8, 96, 95, 1),
    (0x4f46, 97, 101, 0), (0x47e5, 98, 102, 0), (0x41cf, 99, 103, 0), (0x3c3d, 100, 104, 0),
    (0x375e, 93, 99, 0), (0x5231, 102, 105, 0), (0x4c0f, 103, 106, 0), (0x4639, 104, 107, 0),
    (0x415e, 99, 103, 0), (0x5627, 106, 105, 1), (0x50e7, 107, 108, 0), (0x4b85, 103, 109, 0),
    (0x5597, 109, 110, 0), (0x504f, 107, 111, 0), (0x5a10, 111, 110, 1), (0x5522, 109, 112, 0),
    (0x59eb, 111, 112, 1), (0x5a1d, 113, 113, 0)]


def _seg(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def _huff_codes(bits, vals) -> dict:
    """value -> (code, length) of a DHT table (Annex C)."""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _category(v: int) -> int:
    return 0 if v == 0 else int(abs(v)).bit_length()


class _Bits:
    """Huffman-coded data: bits MSB first, 0xFF stuffed, 1-padded."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, code: int, length: int):
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            b = (self.acc >> (self.n - 8)) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
            self.n -= 8
        self.acc &= (1 << self.n) - 1

    def value(self, v: int, s: int):
        if s:
            self.put(v if v >= 0 else v - 1, s)

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


# ------------------------------------------------------- frames and coefficients


def read_baseline(data: bytes) -> dict:
    """The frame of a baseline Huffman JPEG with one interleaved scan."""
    pos, qt, dht, app = 2, {}, {}, b""
    frame = None
    while True:
        assert data[pos] == 0xFF
        m = data[pos + 1]
        (ln,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + ln]
        if m == 0xDB:
            p = 0
            while p < len(body):
                tq = body[p] & 15
                zz = np.frombuffer(body[p + 1:p + 65], np.uint8).astype(np.int64)
                nat = np.zeros(64, np.int64)
                nat[ZIGZAG] = zz
                qt[tq] = nat
                p += 65
        elif m == 0xC4:
            p = 0
            while p < len(body):
                tc, th = body[p] >> 4, body[p] & 15
                bits = list(body[p + 1:p + 17])
                vals = list(body[p + 17:p + 17 + sum(bits)])
                dht[(tc, th)] = {v: k for k, v in _huff_codes(bits, vals).items()}
                p += 17 + sum(bits)
        elif m == 0xC0:
            h, w, nc = struct.unpack(">HHB", body[1:6])
            comps = [(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15,
                      body[8 + 3 * i]) for i in range(nc)]
            frame = dict(w=w, h=h, comps=comps, qt=qt, app=app)
        elif m == 0xDA:
            ns = body[0]
            tables = [(body[2 + 2 * i] >> 4, body[2 + 2 * i] & 15) for i in range(ns)]
            pos = pos + 2 + ln
            end = data.index(b"\xff\xd9", pos)
            frame["coef"] = _huffman_scan(frame, data[pos:end], tables, dht)
            return frame
        elif 0xE0 <= m <= 0xEF and not qt:
            app += data[pos:pos + 2 + ln]
        pos += 2 + ln


def _layout(frame):
    """(hmax, vmax, MCUs across, MCUs down, per component (bw, bh))."""
    hmax = max(c[1] for c in frame["comps"])
    vmax = max(c[2] for c in frame["comps"])
    mx, my = -(-frame["w"] // (8 * hmax)), -(-frame["h"] // (8 * vmax))
    if len(frame["comps"]) == 1:
        return 1, 1, -(-frame["w"] // 8), -(-frame["h"] // 8), [(-(-frame["w"] // 8),
                                                                  -(-frame["h"] // 8))]
    return hmax, vmax, mx, my, [(mx * c[1], my * c[2]) for c in frame["comps"]]


def _huffman_scan(frame, ecs: bytes, tables, dht):
    raw = ecs.replace(b"\xff\x00", b"\xff")
    bits = np.unpackbits(np.frombuffer(raw, np.uint8)).tolist()
    at = 0

    def sym(table):
        nonlocal at
        code = 0
        for length in range(1, 17):
            code = (code << 1) | bits[at]
            at += 1
            if (code, length) in table:
                return table[(code, length)]
        raise ValueError("bad code")

    def val(s):
        nonlocal at
        v = 0
        for _ in range(s):
            v = (v << 1) | bits[at]
            at += 1
        return v if s == 0 or v >= 1 << (s - 1) else v - (1 << s) + 1

    hmax, vmax, mx, my, sizes = _layout(frame)
    coef = [np.zeros((bh, bw, 64), np.int64) for bw, bh in sizes]
    pred = [0] * len(frame["comps"])
    single = len(frame["comps"]) == 1
    for y in range(my):
        for x in range(mx):
            for ci, (_, ch, cv, _) in enumerate(frame["comps"]):
                ch, cv = (1, 1) if single else (ch, cv)
                dct, act = dht[(0, tables[ci][0])], dht[(1, tables[ci][1])]
                for yi in range(cv):
                    for xi in range(ch):
                        blk = coef[ci][y * cv + yi, x * ch + xi]
                        s = sym(dct)
                        pred[ci] += val(s)
                        blk[0] = pred[ci]
                        k = 1
                        while k < 64:
                            rs = sym(act)
                            r, s = rs >> 4, rs & 15
                            if s == 0:
                                if r != 15:
                                    break
                                k += 16
                                continue
                            k += r
                            blk[ZIGZAG[k]] = val(s)
                            k += 1
    return coef


def _dct_matrix():
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * np.sqrt(2 / 8)
    m[0] /= np.sqrt(2)
    return m


def coefficients(img: np.ndarray, sampling, quality: int = 85) -> dict:
    """The frame of `img` (uint8 [H, W, 3] or [H, W]) at `sampling`
    [(h, v)] per component, JFIF YCbCr, IJG tables scaled to `quality`."""
    img = img.astype(np.float64)
    grey = img.ndim == 2
    h, w = img.shape[:2]
    if grey:
        planes = [img]
    else:
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    qts = {}
    for tq, base in enumerate((LUMA_Q, CHROMA_Q)):
        zz = np.clip((np.asarray(base) * scale + 50) // 100, 1, 255)
        nat = np.zeros(64, np.int64)
        nat[ZIGZAG] = zz
        qts[tq] = nat
    comps = [(i + 1, hs, vs, min(i, 1)) for i, (hs, vs) in enumerate(sampling)]
    frame = dict(w=w, h=h, comps=comps, qt=qts, app=JFIF)
    hmax, vmax, mx, my, sizes = _layout(frame)
    d = _dct_matrix()
    frame["coef"] = []
    for (cid, hs, vs, tq), plane, (bw, bh) in zip(comps, planes, sizes):
        fx, fy = hmax // hs, vmax // vs
        pw, ph = -(-w // fx), -(-h // fy)
        padded = np.pad(plane, ((0, ph * fy - h), (0, pw * fx - w)), mode="edge")
        small = padded.reshape(ph, fy, pw, fx).mean((1, 3))
        full = np.pad(small, ((0, bh * 8 - ph), (0, bw * 8 - pw)), mode="edge") - 128
        blocks = full.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        dcts = d @ blocks @ d.T
        frame["coef"].append(np.round(dcts.reshape(bh, bw, 64) / qts[tq]).astype(np.int64))
    return frame


def _header(frame, sof: int, precision: int = 8, tables: bytes = b"") -> bytes:
    out = b"\xff\xd8" + frame.get("app", b"")
    for tq, nat in sorted(frame.get("qt", {}).items()):
        out += _seg(0xDB, bytes([tq]) + bytes(np.asarray(nat)[ZIGZAG].astype(np.uint8)))
    body = struct.pack(">BHHB", precision, frame["h"], frame["w"], len(frame["comps"]))
    for cid, hs, vs, tq in frame["comps"]:
        body += bytes([cid, (hs << 4) | vs, tq])
    return out + _seg(sof, body) + tables


def _sos(frame, comps, ss, se, ah, al, table_of=lambda ci: (min(ci, 1), min(ci, 1))) -> bytes:
    body = bytes([len(comps)])
    for ci in comps:
        dc, ac = table_of(ci)
        body += bytes([frame["comps"][ci][0], (dc << 4) | ac])
    return _seg(0xDA, body + bytes([ss, se, (ah << 4) | al]))


def _mcus(frame, comps):
    """(MCU index, [(component, block)]) in scan order."""
    hmax, vmax, mx, my, sizes = _layout(frame)
    if len(comps) == 1:
        ci = comps[0]
        fx = hmax // frame["comps"][ci][1] if len(frame["comps"]) > 1 else 1
        fy = vmax // frame["comps"][ci][2] if len(frame["comps"]) > 1 else 1
        bw = -(-frame["w"] // (8 * fx))
        bh = -(-frame["h"] // (8 * fy))
        for y in range(bh):
            for x in range(bw):
                yield [(ci, frame["coef"][ci][y, x])]
        return
    for y in range(my):
        for x in range(mx):
            blocks = []
            for ci in comps:
                _, ch, cv, _ = frame["comps"][ci]
                for yi in range(cv):
                    for xi in range(ch):
                        blocks.append((ci, frame["coef"][ci][y * cv + yi, x * ch + xi]))
            yield blocks


def huffman_file(frame) -> bytes:
    """A baseline file of the frame's coefficients (standard tables)."""
    tables = b""
    for th in (0, 1):
        tables += _seg(0xC4, bytes([th] + DC_BITS + DC_VALS))
        tables += _seg(0xC4, bytes([0x10 | th] + AC_BITS + AC_VALS))
    dc, ac = _huff_codes(DC_BITS, DC_VALS), _huff_codes(AC_BITS, AC_VALS)
    comps = list(range(len(frame["comps"])))
    bits, pred = _Bits(), [0] * len(comps)
    for blocks in _mcus(frame, comps):
        for ci, blk in blocks:
            zz = blk[ZIGZAG]
            diff = int(zz[0]) - pred[ci]
            pred[ci] = int(zz[0])
            s = _category(diff)
            bits.put(*dc[s])
            bits.value(diff, s)
            run = 0
            last = max([k for k in range(1, 64) if zz[k]], default=0)
            for k in range(1, last + 1):
                v = int(zz[k])
                if v == 0:
                    run += 1
                    continue
                while run > 15:
                    bits.put(*ac[0xF0])
                    run -= 16
                s = _category(v)
                bits.put(*ac[(run << 4) | s])
                bits.value(v, s)
                run = 0
            if last < 63:
                bits.put(*ac[0x00])
    return (_header(frame, 0xC0, tables=tables) + _sos(frame, comps, 0, 63, 0, 0)
            + bits.flush() + b"\xff\xd9")


# ------------------------------------------------------------ arithmetic coding


class _Arith:
    """jcarith.c's encoder (T.81 D.1)."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.ct = 0, 0x10000, 11
        self.sc = self.zc = 0
        self.buffer = -1

    def _emit(self, b):
        self.out.append(b)

    def _flush_zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, st: bytearray, i: int, val: int):
        sv = st[i]
        qe, nm, nl, sw = ARITAB[sv & 0x7F]
        nl |= sw << 7
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._flush_zeros()
                        for _ in range(self.sc):
                            self._emit(0xFF)
                            self._emit(0)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer)
            if self.sc:
                self._flush_zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._flush_zeros()
            b = (self.c >> 19) & 0xFF
            self._emit(b)
            if b == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                b = (self.c >> 11) & 0xFF
                self._emit(b)
                if b == 0xFF:
                    self._emit(0)
        return bytes(self.out)


def _magnitude(e: _Arith, st: bytearray, i: int, x1: int, v: int, ac: bool) -> int:
    """Figures F.8 and F.9 for |v| >= 1 from bin `i`; returns the category's
    power of two (DC conditioning)."""
    v -= 1
    m = 0
    if v:
        e.encode(st, i, 1)
        m = 1
        v2 = v
        if ac:
            v2 >>= 1
            if v2:
                e.encode(st, i, 1)
                m <<= 1
                i = x1
                while True:
                    v2 >>= 1
                    if not v2:
                        break
                    e.encode(st, i, 1)
                    m <<= 1
                    i += 1
        else:
            i = x1
            while True:
                v2 >>= 1
                if not v2:
                    break
                e.encode(st, i, 1)
                m <<= 1
                i += 1
    e.encode(st, i, 0)
    cat = m
    i += 14
    while m > 1:
        m >>= 1
        e.encode(st, i, 1 if m & v else 0)
    return cat


def arithmetic_file(frame, progressive: bool = False, restart: int = 0, dac=None) -> bytes:
    """SOF9 or SOF10 of the frame's coefficients.  `dac`: {table: (L, U)}
    for DC and {16 + table: Kx} for AC conditioning; the progressive scan
    script is libjpeg's jpeg_simple_progression for the component count."""
    dac = dac or {}
    L = {t: dac.get(t, (0, 1))[0] for t in range(2)}
    U = {t: dac.get(t, (0, 1))[1] for t in range(2)}
    K = {t: dac.get(16 + t, 5) for t in range(2)}
    tables = b""
    if dac:
        body = b""
        for t, v in sorted(dac.items()):
            body += bytes([t, v if t >= 16 else (v[1] << 4) | v[0]])
        tables += _seg(0xCC, body)
    if restart:
        tables += _seg(0xDD, struct.pack(">H", restart))
    nc = len(frame["comps"])
    if not progressive:
        scans = [(list(range(nc)), 0, 63, 0, 0)]
    elif nc == 3:
        scans = [([0, 1, 2], 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([2], 1, 63, 0, 1),
                 ([1], 1, 63, 0, 1), ([0], 6, 63, 0, 2), ([0], 1, 63, 2, 1),
                 ([0, 1, 2], 0, 0, 1, 0), ([2], 1, 63, 1, 0), ([1], 1, 63, 1, 0),
                 ([0], 1, 63, 1, 0)]
    else:
        scans = [([0], 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([0], 6, 63, 0, 2), ([0], 1, 63, 2, 1),
                 ([0], 0, 0, 1, 0), ([0], 1, 63, 1, 0)]
    out = _header(frame, 0xCA if progressive else 0xC9, tables=tables)
    for comps, ss, se, ah, al in scans:
        out += _sos(frame, comps, ss, se, ah, al)
        out += _arith_scan(frame, comps, ss, se, ah, al, progressive, restart, L, U, K)
    return out + b"\xff\xd9"


def _arith_scan(frame, comps, ss, se, ah, al, progressive, restart, L, U, K) -> bytes:
    tbl = lambda ci: min(ci, 1)
    fixed = bytearray([113])

    def fresh():
        return ([bytearray(64) for _ in range(2)], [bytearray(256) for _ in range(2)],
                {ci: 0 for ci in comps}, {ci: 0 for ci in comps})

    dcs, acs, last, ctx = fresh()
    e, out, count, rst = _Arith(), b"", 0, 0
    for blocks in _mcus(frame, comps):
        if restart and count and count % restart == 0:
            out += e.finish() + bytes([0xFF, 0xD0 + rst])
            rst = (rst + 1) & 7
            e = _Arith()
            dcs, acs, last, ctx = fresh()
        count += 1
        for ci, blk in blocks:
            zz = [int(v) for v in blk[ZIGZAG]]
            t = tbl(ci)
            if not progressive or (ss == 0 and ah == 0):
                dc = zz[0] >> al                                # arithmetic shift (IRIGHT_SHIFT)
                st, base = dcs[t], ctx[ci]
                v = dc - last[ci]
                if v == 0:
                    e.encode(st, base, 0)
                    ctx[ci] = 0
                else:
                    last[ci] = dc
                    e.encode(st, base, 1)
                    sign = int(v < 0)
                    e.encode(st, base + 1, sign)
                    cat = _magnitude(e, st, base + 2 + sign, 20, abs(v), False)
                    if cat < (1 << L[t]) >> 1:
                        ctx[ci] = 0
                    elif cat > (1 << U[t]) >> 1:
                        ctx[ci] = 12 + 4 * sign
                    else:
                        ctx[ci] = 4 + 4 * sign
                if progressive:
                    continue
            elif ss == 0:
                e.encode(fixed, 0, (zz[0] >> al) & 1)
                continue
            lo, hi = (1, 63) if not progressive else (ss, se)
            st = acs[t]
            mag = [abs(v) >> al for v in zz]
            ke = hi
            while ke >= lo and mag[ke] == 0:
                ke -= 1
            kex = 0
            if progressive and ah:
                kex = ke
                while kex >= lo and (abs(zz[kex]) >> ah) == 0:
                    kex -= 1
            k = lo
            while k <= ke:
                i = 3 * (k - 1)
                if not (progressive and ah) or k > kex:
                    e.encode(st, i, 0)                          # not the end of block
                while True:
                    if mag[k]:
                        if progressive and ah and mag[k] >> 1:  # refinement bit
                            e.encode(st, i + 2, mag[k] & 1)
                        else:
                            e.encode(st, i + 1, 1)
                            e.encode(fixed, 0, int(zz[k] < 0))
                            if not (progressive and ah):
                                _magnitude(e, st, i + 2, 189 if k <= K[t] else 217, mag[k],
                                           True)
                        break
                    e.encode(st, i + 1, 0)
                    i += 3
                    k += 1
                k += 1
            if k <= hi:
                e.encode(st, 3 * (k - 1), 1)                    # end of block
    return out + e.finish()


# ---------------------------------------------------------------- lossless


def lossless_file(img: np.ndarray, predictor: int, pt: int = 0, precision: int = 8,
                  restart_rows: int = 0, ids=b"\x01\x02\x03", jfif: bool = False,
                  sampling=None) -> bytes:
    """SOF3 of uint8 [H, W] or [H, W, C] samples below 2**precision, one
    interleaved scan, the standard luminance DC table for the differences.
    `sampling` [(h, v)] per component subsamples each by keeping the first
    sample of every (hmax / h) x (vmax / v) box; an MCU's samples past a
    component's edge are coded as zero differences.  `restart_rows` counts
    MCU rows."""
    x = img.reshape(img.shape[0], img.shape[1], -1).astype(np.int64) >> pt
    h, w, nc = x.shape
    sampling = sampling or [(1, 1)] * nc
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    planes = [x[::vmax // sv, ::hmax // sh, c] for c, (sh, sv) in enumerate(sampling)]
    mpr, mrows = -(-w // hmax), -(-h // vmax)
    frame = dict(w=w, h=h, comps=[(ids[i], *sampling[i], 0) for i in range(nc)],
                 app=JFIF if jfif else b"")
    tables = _seg(0xC4, bytes([0] + DC_BITS + DC_VALS))
    if restart_rows:
        tables += _seg(0xDD, struct.pack(">H", restart_rows * mpr))
    dc = _huff_codes(DC_BITS, DC_VALS)
    out = _header(frame, 0xC3, precision, tables) + _seg(
        0xDA, bytes([nc]) + b"".join(bytes([ids[i], 0]) for i in range(nc))
        + bytes([predictor, 0, pt]))
    bits, rst, row0 = _Bits(), 0, 0
    for my in range(mrows):
        if restart_rows and my and my % restart_rows == 0:
            out += bits.flush() + bytes([0xFF, 0xD0 + rst])
            rst = (rst + 1) & 7
            bits, row0 = _Bits(), my
        for mx in range(mpr):
            for c, (sh, sv) in enumerate(sampling):
                p_ = planes[c]
                for r in range(sv):
                    for q in range(sh):
                        y, xx = my * sv + r, mx * sh + q
                        if y >= p_.shape[0] or xx >= p_.shape[1]:
                            bits.put(*dc[0])
                            continue
                        if y == row0 * sv:
                            p = 1 << (precision - pt - 1) if xx == 0 else p_[y, xx - 1]
                        elif xx == 0:
                            p = p_[y - 1, 0]
                        else:
                            ra, rb, rc = p_[y, xx - 1], p_[y - 1, xx], p_[y - 1, xx - 1]
                            p = [None, ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                                 rb + ((ra - rc) >> 1), (ra + rb) >> 1][predictor]
                        diff = int(p_[y, xx] - p)
                        s = _category(diff)
                        bits.put(*dc[s])
                        bits.value(diff, s)
    return out + bits.flush() + b"\xff\xd9"


def cut_scans(data: bytes, k: int) -> bytes:
    """The file up to (not including) its (k + 1)-th SOS, then EOI."""
    pos, seen = 2, 0
    while True:
        (ln,) = struct.unpack(">H", data[pos + 2:pos + 4])
        if data[pos + 1] == 0xDA:
            seen += 1
            if seen > k:
                return data[:pos] + b"\xff\xd9"
            end = pos + 2 + ln
            while not (data[end] == 0xFF and data[end + 1] not in (0,) and
                       not 0xD0 <= data[end + 1] <= 0xD7):
                end += 1
            pos = end
            continue
        pos += 2 + ln
