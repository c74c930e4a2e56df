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
    if 8 % depth:                              # 12 bits and the like: any bit packing
        bits = (flat[..., None] >> np.arange(depth - 1, -1, -1, dtype=np.uint32)) & 1
        return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)
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
    u = block.view(f"u{block.dtype.itemsize}") if block.dtype.kind != "u" else block
    d = u.astype(np.uint64)
    d[:, 1:] = d[:, 1:] - d[:, :-1]
    return (d & np.uint64((1 << bits) - 1)).astype(u.dtype)


def _predict_float(block: np.ndarray) -> bytes:
    """libtiff's floating-point predictor (3): each row's bytes split into
    planes, most significant first, then differenced bytewise by samples."""
    rows, cols, spp = block.shape
    size = block.dtype.itemsize
    out = bytearray()
    for row in block:
        b = row.astype("<" + block.dtype.str[1:]).view(np.uint8).reshape(cols * spp, size)
        planes = b[:, ::-1].T.reshape(-1).astype(np.int64)
        planes[spp:] = planes[spp:] - planes[:-spp]
        out += (planes & 0xFF).astype(np.uint8).tobytes()
    return bytes(out)


def _sample_bytes(block: np.ndarray, bits: int, bo: str) -> bytes:
    """[rows, cols, spp] samples -> bytes, each row padded to a byte."""
    if bits in (16, 32, 64):
        kind = block.dtype.kind if block.dtype.kind in "if" else "u"
        return block.astype(f"{bo}{kind}{bits // 8}").tobytes()
    if bits == 8:
        return block.astype(np.uint8 if block.dtype.kind != "i" else np.int8).tobytes()
    return _pack_rows(block, bits).tobytes()


REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _coder(compression):
    import lzma

    if callable(compression):
        return compression
    if compression == 34925:      # libtiff's LZMA: an xz stream without a check
        return lambda b: lzma.compress(b, format=lzma.FORMAT_XZ, check=lzma.CHECK_NONE)
    if compression == 50000:
        import zstandard

        return lambda b: zstandard.ZstdCompressor(level=3).compress(b)
    return {1: lambda b: b, 32773: packbits, 5: lzw_tiff, 8: zlib.compress,
            32946: zlib.compress}[compression]


def tiff_file(samples: np.ndarray, bits: int, photometric: int, big_endian: bool = False,
              compression=1, predictor: int = 1, planar: int = 1, tile=None,
              rows_per_strip: int = None, extra=None, tags=None, fill_order: int = 1,
              big_tiff: bool = False, sample_format=None, chunks=None) -> bytes:
    """A one-IFD TIFF of `samples` [h, w, spp] (unsigned, signed or float at
    8, 16, 32 or 64 bits, or fewer bits packed).  `tile` (tw, th) writes
    tiles; `extra` the ExtraSamples values; `tags` {tag: (type, values)}
    more entries (a ColorMap, an InkSet ...).  `compression` is a TIFF code
    (none, PackBits, LZW, Deflate, LZMA, Zstandard) or a callable coding
    one strip's bytes, written under tag 259 = `tags`' value; `chunks` gives
    the coded strips or tiles outright (JPEG).  `fill_order` 2 reverses the
    bits of every coded byte; `big_tiff` writes BigTIFF (version 43, 8-byte
    offsets); predictor 3 is libtiff's floating-point predictor."""
    bo = ">" if big_endian else "<"
    h, w, spp = samples.shape
    comp = _coder(compression) if chunks is None else None
    planes = [samples[..., i:i + 1] for i in range(spp)] if planar == 2 else [samples]

    def code(blk):
        if predictor == 3:
            return comp(_predict_float(blk))
        if predictor == 2:
            blk = _predict(blk, bits)
        return comp(_sample_bytes(blk, bits, bo))

    if chunks is None:
        chunks = []
        if tile:
            tw, th = tile
            for p in planes:
                for ty in range(0, h, th):
                    for tx in range(0, w, tw):
                        t = np.zeros((th, tw, p.shape[2]), samples.dtype)
                        blk = p[ty:ty + th, tx:tx + tw]
                        t[:blk.shape[0], :blk.shape[1]] = blk
                        chunks.append(code(t))
        else:
            rps = rows_per_strip or h
            for p in planes:
                for y in range(0, h, rps):
                    chunks.append(code(p[y:y + rps]))
    if fill_order == 2:
        chunks = [REVERSED[np.frombuffer(c, np.uint8)].tobytes() for c in chunks]
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
               259: (3, [compression if isinstance(compression, int) else 1]),
               262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        entries[317] = (3, [predictor])
    if extra is not None:
        entries[338] = (3, list(extra))
    if fill_order != 1:
        entries[266] = (3, [fill_order])
    if sample_format is not None:
        entries[339] = (3, list(sample_format))
    if tile:
        entries[322] = (4, [tile[0]])
        entries[323] = (4, [tile[1]])
    else:
        entries[278] = (4, [rows_per_strip or h])
    entries.update(tags or {})
    offsets_tag, counts_tag = (324, 325) if tile else (273, 279)
    wide = 16 if big_tiff else 4
    entries[counts_tag] = (wide, [len(c) for c in chunks])
    entries[offsets_tag] = (wide, [0] * len(chunks))
    return _tiff_layout(entries, chunks, offsets_tag, bo, big_tiff)


_FMT = {1: "B", 2: "s", 3: "H", 4: "I", 5: "I", 6: "b", 7: "B", 8: "h", 9: "i", 10: "i", 11: "f",
        12: "d", 16: "Q", 17: "q"}


def _tiff_layout(entries: dict, chunks, offsets_tag: int, bo: str, big: bool) -> bytes:
    """Header, one IFD (tags sorted, values that do not fit in the entry
    after it), then the chunks; `offsets_tag`'s values are the chunks'."""
    slot, head = (8, 16) if big else (4, 8)
    n = len(entries)
    ifd_len = (8 + 20 * n + 8) if big else (2 + 12 * n + 4)
    data_at = head + ifd_len

    def raw(typ, vals):
        if typ == 2:
            return bytes(vals)
        return b"".join(struct.pack(bo + _FMT[typ], v) for v in vals)

    over_len = 0
    for tag in sorted(entries):
        r = raw(*entries[tag])
        if len(r) > slot:
            over_len += len(r) + len(r) % 2
    pos, starts = data_at + over_len, []
    for c in chunks:
        starts.append(pos)
        pos += len(c) + len(c) % 2
    typ = entries[offsets_tag][0]
    entries = dict(entries)
    entries[offsets_tag] = (typ, starts)
    ifd = bytearray(struct.pack(bo + ("Q" if big else "H"), n))
    overflow = bytearray()
    for tag in sorted(entries):
        typ, vals = entries[tag]
        r = raw(typ, vals)
        count = len(vals) // 2 if typ in (5, 10) else len(vals)     # rationals: pairs
        if len(r) <= slot:
            value = r.ljust(slot, b"\x00")
        else:
            value = struct.pack(bo + ("Q" if big else "I"), data_at + len(overflow))
            overflow += r + (b"\x00" if len(r) % 2 else b"")
        ifd += struct.pack(bo + ("HHQ" if big else "HHI"), tag, typ, count) + value
    ifd += struct.pack(bo + ("Q" if big else "I"), 0)
    if big:
        header = (b"MM" if bo == ">" else b"II") + struct.pack(bo + "HHHQ", 43, 8, 0, head)
    else:
        header = (b"MM" if bo == ">" else b"II") + struct.pack(bo + "HI", 42, head)
    assert len(header) + len(ifd) == data_at and len(overflow) == over_len
    return header + bytes(ifd) + bytes(overflow) + b"".join(
        c + (b"\x00" if len(c) % 2 else b"") for c in chunks)
