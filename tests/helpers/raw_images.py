"""Writers of the PNG, GIF and TIFF variants Pillow does not write itself
(numpy, zlib and struct), for the tests that hold the port's readers to
Pillow: Pillow opens each file these write and is the oracle.

* `png_file`: any bit depth and colour type, Adam7 or not, a seeded filter
  type (0-4) on every row, PLTE and tRNS;
* `gif_file`: a logical screen with an optional global colour table, one
  or two frames placed anywhere on it, each with an optional local colour
  table, interlaced rows and a transparency index; LZW as GIF writes it
  (`lzw_gif`);
* `tiff_file`: one IFD, little- or big-endian, strips or tiles, chunky or
  planar samples, compression none, PackBits, LZW or Deflate, predictor 2,
  any photometric interpretation and extra tags.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, w, spp] samples -> [h, stride] bytes (MSB first below 8 bits)."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.uint32)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    n = flat.shape[1]
    pad = np.zeros((h, (-n) % per), np.uint32)
    flat = np.concatenate([flat, pad], 1).reshape(h, -1, per)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint32)
    return (flat << shifts).sum(-1).astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(rows: np.ndarray, bpp: int, rng) -> bytes:
    out = []
    prior = np.zeros(rows.shape[1], np.int32)
    for row in rows.astype(np.int32):
        ft = int(rng.randint(5))
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        pred = [0, left, prior, (left + prior) >> 1, _paeth(left, prior, upleft)][ft]
        out.append(bytes([ft]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes())
        prior = row
    return b"".join(out)


def png_file(samples: np.ndarray, depth: int, ctype: int, interlace: bool = False,
             palette=None, trns: bytes = None, seed: int = 0, level: int = 6) -> bytes:
    """A PNG of `samples` [h, w, spp] (ints at `depth`)."""
    rng = np.random.RandomState(seed)
    h, w, spp = samples.shape
    bpp = max(1, depth * spp // 8)
    if interlace:
        parts = []
        for x0, y0, dx, dy in ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                parts.append(_filter_rows(_pack_rows(sub, depth), bpp, rng))
        raw = b"".join(parts)
    else:
        raw = _filter_rows(_pack_rows(samples, depth), bpp, rng)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                                               0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw, level)) + _chunk(b"IEND", b"")


# ------------------------------------------------------------------- GIF


def lzw_gif(indices: np.ndarray, min_size: int) -> bytes:
    """GIF's variable-length LZW (LSB first, a clear code first, codes up to
    12 bits, a clear code whenever the table fills) in sub-blocks."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    table = {}
    size, nxt = min_size + 1, eoi + 1
    acc = nbits = 0
    out = bytearray()

    def put(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    put(clear)
    data = indices.reshape(-1).tolist()
    prefix = data[0] if data else None
    for k in data[1:]:
        key = (prefix, k)
        if key in table:
            prefix = table[key]
            continue
        put(prefix)
        if nxt < 4096:
            table[key] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        else:
            put(clear)
            table.clear()
            size, nxt = min_size + 1, eoi + 1
        prefix = k
    if prefix is not None:
        put(prefix)
    put(eoi)
    if nbits:
        out.append(acc & 0xFF)
    blocks = b"".join(bytes([len(out[i:i + 255])]) + bytes(out[i:i + 255])
                      for i in range(0, len(out), 255))
    return bytes([min_size]) + blocks + b"\x00"


def _table(pal) -> tuple:
    pal = np.asarray(pal, np.uint8).reshape(-1, 3)
    bits = max(1, int(np.ceil(np.log2(max(2, len(pal))))))
    full = np.zeros((1 << bits, 3), np.uint8)
    full[:len(pal)] = pal
    return bits, full.tobytes()


def gif_file(size, frames, global_palette=None, background: int = 0) -> bytes:
    """A GIF89a of logical screen `size` (w, h).  `frames`: dicts with
    `indices` [h, w], `at` (x, y), and optionally `palette` (a local table),
    `interlace`, `transparency` (an index) and `min_size` (the LZW minimum
    code size)."""
    w, h = size
    flags, gct = 0, b""
    if global_palette is not None:
        bits, gct = _table(global_palette)
        flags = 0x80 | (7 << 4) | (bits - 1)
    out = b"GIF89a" + struct.pack("<HHBBB", w, h, flags, background, 0) + gct
    for fr in frames:
        idx = np.asarray(fr["indices"], np.uint8)
        fh, fw = idx.shape
        if "transparency" in fr:
            out += b"!\xf9\x04" + struct.pack("<BHB", 1, 0, fr["transparency"]) + b"\x00"
        lflags, lct = 0, b""
        if fr.get("palette") is not None:
            bits, lct = _table(fr["palette"])
            lflags = 0x80 | (bits - 1)
        if fr.get("interlace"):
            lflags |= 0x40
            order = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8), np.arange(2, fh, 4),
                                    np.arange(1, fh, 2)])
            idx = idx[order]
        x, y = fr.get("at", (0, 0))
        out += b"," + struct.pack("<HHHHB", x, y, fw, fh, lflags) + lct
        out += lzw_gif(idx, fr.get("min_size", max(2, int(idx.max()).bit_length())))
    return out + b";"


# ------------------------------------------------------------------ TIFF


def packbits(data: bytes) -> bytes:
    """PackBits: literal runs and repeats of up to 128 bytes."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (j + 1 < n and data[j + 1] == data[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def lzw_tiff(data: bytes) -> bytes:
    """TIFF's LZW (MSB first, the early change: codes widen one code early)."""
    table = {bytes([i]): i for i in range(256)}
    size, nxt = 9, 258
    acc = nbits = 0
    out = bytearray()

    def put(code):
        nonlocal acc, nbits
        acc = (acc << size) | code
        nbits += size
        while nbits >= 8:
            out.append((acc >> (nbits - 8)) & 0xFF)
            nbits -= 8
        acc &= (1 << nbits) - 1

    put(256)
    w = b""
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = nxt
        nxt += 1
        if nxt == 4094:                  # libtiff's encoder: a clear code before the table fills
            put(256)
            table = {bytes([i]): i for i in range(256)}
            size, nxt = 9, 258
        elif nxt > (1 << size) - 1:
            size += 1
        w = bytes([b])
    if w:
        put(table[w])
    put(257)
    if nbits:
        out.append((acc << (8 - nbits)) & 0xFF)
    return bytes(out)


def _predict(block: np.ndarray, bits: int) -> np.ndarray:
    """Horizontal differencing (predictor 2) of [rows, cols, spp] samples."""
    d = block.astype(np.int64)
    d[:, 1:] = d[:, 1:] - d[:, :-1]
    return (d & ((1 << bits) - 1)).astype(block.dtype)


def _sample_bytes(block: np.ndarray, bits: int, bo: str) -> bytes:
    """[rows, cols, spp] samples -> bytes, each row padded to a byte."""
    if bits == 16:
        return block.astype(bo + "u2").tobytes()
    if bits == 8:
        return block.astype(np.uint8).tobytes()
    return _pack_rows(block, bits).tobytes()


def tiff_file(samples: np.ndarray, bits: int, photometric: int, big_endian: bool = False,
              compression: int = 1, predictor: int = 1, planar: int = 1, tile=None,
              rows_per_strip: int = None, extra=None, tags=None) -> bytes:
    """A one-IFD TIFF of `samples` [h, w, spp].  `tile` (tw, th) writes
    tiles; `extra` the ExtraSamples values; `tags` {tag: (type, values)}
    more entries (a ColorMap, an InkSet ...)."""
    bo = ">" if big_endian else "<"
    h, w, spp = samples.shape
    comp = {1: lambda b: b, 32773: packbits, 5: lzw_tiff, 8: zlib.compress,
            32946: zlib.compress}[compression]
    planes = [samples[..., i:i + 1] for i in range(spp)] if planar == 2 else [samples]
    chunks = []
    if tile:
        tw, th = tile
        for p in planes:
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    t = np.zeros((th, tw, p.shape[2]), samples.dtype)
                    blk = p[ty:ty + th, tx:tx + tw]
                    t[:blk.shape[0], :blk.shape[1]] = blk
                    if predictor == 2:
                        t = _predict(t, bits)
                    chunks.append(comp(_sample_bytes(t, bits, bo)))
    else:
        rps = rows_per_strip or h
        for p in planes:
            for y in range(0, h, rps):
                blk = p[y:y + rps]
                if predictor == 2:
                    blk = _predict(blk, bits)
                chunks.append(comp(_sample_bytes(blk, bits, bo)))
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
               262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        entries[317] = (3, [predictor])
    if extra is not None:
        entries[338] = (3, list(extra))
    if tile:
        entries[322] = (4, [tile[0]])
        entries[323] = (4, [tile[1]])
    else:
        entries[278] = (4, [rows_per_strip or h])
    entries.update(tags or {})
    header = (b"MM" if big_endian else b"II") + struct.pack(bo + "HI", 42, 8)
    n = len(entries) + 2
    data_at = 8 + 2 + 12 * n + 4
    fmt = {3: "H", 4: "I"}
    overflow, chunk_at = bytearray(), []
    ifd = bytearray(struct.pack(bo + "H", n))

    def entry(tag, typ, vals):
        raw = b"".join(struct.pack(bo + fmt[typ], v) for v in vals)
        if len(raw) <= 4:
            return struct.pack(bo + "HHI", tag, typ, len(vals)) + raw.ljust(4, b"\x00")
        at = data_at + len(overflow)
        overflow.extend(raw + (b"\x00" if len(raw) % 2 else b""))
        return struct.pack(bo + "HHI", tag, typ, len(vals)) + struct.pack(bo + "I", at)

    offsets_tag, counts_tag = (324, 325) if tile else (273, 279)
    body = []
    for tag in sorted(list(entries) + [offsets_tag, counts_tag]):
        if tag == offsets_tag:
            body.append((tag, None))
        elif tag == counts_tag:
            body.append((tag, (4, [len(c) for c in chunks])))
        else:
            body.append((tag, entries[tag]))
    # the strip offsets come after the IFD's overflow; size the overflow first
    for tag, v in body:
        if v is not None:
            entry(tag, *v)
    k = len(chunks)
    offsets_len = 4 * k if k > 1 else 0
    start = data_at + len(overflow) + offsets_len
    starts, pos = [], start
    for c in chunks:
        starts.append(pos)
        pos += len(c) + (len(c) % 2)
    overflow.clear()
    for tag, v in body:
        ifd += entry(tag, *(v if v is not None else (4, starts)))
    ifd += struct.pack(bo + "I", 0)
    assert len(header) + len(ifd) == data_at and data_at + len(overflow) == start
    return header + bytes(ifd) + bytes(overflow) + b"".join(
        c + (b"\x00" if len(c) % 2 else b"") for c in chunks)
