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
  any photometric interpretation and extra tags;
* `dds_file`, `blp1_file`, `blp2_file`, `ftex_file`: texture containers
  around data the caller gives (block-compressed, masked, palette, JPEG).
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


# ----------------------------------------------------- the raster formats
# Writers of what Pillow 12.1 reads but does not write: plain Netpbm and
# `Pf`, Sun raster, PSD, XPM, FITS, DCX, CUR, RLE SGI and colour-mapped (or
# RLE) Targa.


def netpbm_plain(samples: np.ndarray, maxval: int = 255, comment: bytes = b"") -> bytes:
    """P1 (bool [h, w]), P2 ([h, w]) or P3 ([h, w, 3]), a comment in the
    header, rows on lines of their own."""
    h, w = samples.shape[:2]
    if samples.dtype == np.bool_:
        head, body = b"P1", [b"".join(b"1" if v else b"0" for v in row) for row in samples]
    else:
        head = b"P3" if samples.ndim == 3 else b"P2"
        body = [b" ".join(str(int(v)).encode() for v in row.reshape(-1)) for row in samples]
    maxline = b"" if head == b"P1" else b" %d" % maxval
    return (head + b"\n# " + comment + b"\n%d %d" % (w, h) + maxline + b"\n"
            + b"\n".join(body) + b"\n")


def pfm_grey(values: np.ndarray, scale: float = -1.0) -> bytes:
    """`Pf`: grey float32 rows bottom-up, little-endian for a negative scale."""
    h, w = values.shape
    order = "<f4" if scale < 0 else ">f4"
    return b"Pf\n%d %d\n%s\n" % (w, h, repr(scale).encode()) + \
        values[::-1].astype(order).tobytes()


def sun_rle_bytes(data: bytes) -> bytes:
    """Sun RLE: 0x80 n v for n + 1 copies (n >= 2), 0x80 0x00 for 0x80."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j + 1 < len(data) and data[j + 1] == data[i] and j - i < 255:
            j += 1
        run = j - i + 1
        if run >= 3:
            out += bytes([0x80, run - 1, data[i]])
        else:
            for _ in range(run):
                out += b"\x80\x00" if data[i] == 0x80 else bytes([data[i]])
        i = j + 1
    return bytes(out)


def sun_file(pixels: np.ndarray, depth: int, ftype: int = 1, colormap=None) -> bytes:
    """A Sun raster: `pixels` as stored values ([h, w] indices, bits or
    grey; [h, w, 3] in the file's byte order; [h, w, 4] for 32 bits), rows
    padded to 16 bits, RLE for type 2, an RGB colour map ([n, 3])."""
    h, w = pixels.shape[:2]
    if depth == 1:
        rows = np.packbits(pixels.astype(np.uint8), axis=1)
    elif depth == 4:
        rows = _pack_rows(pixels[..., None], 4)
    else:
        rows = pixels.reshape(h, -1).astype(np.uint8)
    stride = ((w * depth + 15) // 16) * 2
    rows = np.concatenate([rows, np.zeros((h, stride - rows.shape[1]), np.uint8)], 1)
    data = rows.tobytes()
    if ftype == 2:
        data = sun_rle_bytes(data)
    cmap = b"" if colormap is None else np.ascontiguousarray(
        np.asarray(colormap, np.uint8).T).tobytes()
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(data), ftype,
                       1 if len(cmap) else 0, len(cmap)) + cmap + data


def psd_file(channels: np.ndarray, mode: int, compression: int = 0, palette=None,
             depth: int = 8, resources: bytes = b"", layers: bytes = b"") -> bytes:
    """A PSD of `channels` [c, h, w] (bit rows packed for depth 1) in colour
    mode `mode`, raw or PackBits, with a 768-byte planar palette for
    indexed colour."""
    c, h = channels.shape[:2]
    w = channels.shape[2] * (8 if depth == 1 else 1)
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, c, h, w, depth, mode)
    cmode = b"" if palette is None else np.ascontiguousarray(
        np.asarray(palette, np.uint8).T).tobytes()
    out = head + struct.pack(">I", len(cmode)) + cmode
    out += struct.pack(">I", len(resources)) + resources
    out += struct.pack(">I", len(layers)) + layers
    if compression == 0:
        return out + b"\0\0" + channels.astype(np.uint8).tobytes()
    rows = [packbits(row.tobytes()) for plane in channels.astype(np.uint8) for row in plane]
    return (out + b"\0\1" + b"".join(struct.pack(">H", len(r)) for r in rows)
            + b"".join(rows))


def psd_resource(rid: int, data: bytes, name: bytes = b"") -> bytes:
    """One image resource block (signature, id, Pascal name padded, data)."""
    pascal = bytes([len(name)]) + name
    pascal += b"\0" * (len(pascal) % 2)
    return b"8BIM" + struct.pack(">H", rid) + pascal + struct.pack(">I", len(data)) + data + \
        b"\0" * (len(data) % 2)


def xpm_file(indices: np.ndarray, colours, cpp: int = 1, pixels_comment: bool = True) -> bytes:
    """An XPM of `indices` [h, w] into `colours` (["#rrggbb" or "None"]), the
    keys `cpp` characters of printable ASCII."""
    h, w = indices.shape
    alphabet = [chr(c) for c in range(35, 127) if chr(c) not in '\\"']
    keys = []
    for i in range(len(colours)):
        k, j = "", i
        for _ in range(cpp):
            k += alphabet[j % len(alphabet)]
            j //= len(alphabet)
        keys.append(k)
    lines = ["/* XPM */", "static char *image[] = {", "/* columns rows colors chars */",
             f'"{w} {h} {len(colours)} {cpp}",']
    lines += [f'"{k} c {c}",' for k, c in zip(keys, colours)]
    if pixels_comment:
        lines.append("/* pixels */")
    lines += ['"' + "".join(keys[v] for v in row) + '",' for row in indices]
    lines[-1] = lines[-1].rstrip(",")
    return ("\n".join(lines) + "\n};\n").encode()


def fits_file(values: np.ndarray, bitpix: int, extra_cards=()) -> bytes:
    """A FITS primary HDU: `values` [h, w] big-endian, rows bottom-up,
    header and data padded to 2880 bytes."""
    h, w = values.shape
    cards = ["SIMPLE  =                    T", f"BITPIX  = {bitpix:20d}",
             "NAXIS   =                    2", f"NAXIS1  = {w:20d}", f"NAXIS2  = {h:20d}",
             *extra_cards, "END"]
    head = b"".join(c.ljust(80).encode() for c in cards)
    head += b" " * (-len(head) % 2880)
    dt = {8: "u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    data = values[::-1].astype(dt).tobytes()
    return head + data + b"\0" * (-len(data) % 2880)


def dcx_file(pages) -> bytes:
    """A DCX of PCX files (bytes each)."""
    at = 4 + 4 * (len(pages) + 1)
    offsets = []
    for p in pages:
        offsets.append(at)
        at += len(p)
    return (struct.pack("<I", 0x3ADE68B1) + b"".join(struct.pack("<I", o) for o in offsets)
            + b"\0\0\0\0" + b"".join(pages))


def dib_bitmap(pixels: np.ndarray, bits: int, palette=None, mask=None) -> bytes:
    """A BITMAPINFOHEADER bitmap with no file header, stored height doubled
    and an AND mask ([h, w] bool, True transparent) after the colour rows,
    as icons and cursors hold it.  `pixels`: [h, w] indices or [h, w, 3|4]
    RGB(A)."""
    h, w = pixels.shape[:2]
    pal = b""
    if bits <= 8:
        pal = b"".join(bytes([b, g, r, 0]) for r, g, b in np.asarray(palette, np.uint8))
        rows = _pack_rows(pixels[..., None], bits) if bits < 8 else pixels.astype(np.uint8)
    else:
        order = [2, 1, 0, 3][:bits // 8]
        rows = pixels[..., order].reshape(h, -1).astype(np.uint8)
    stride = ((w * bits + 31) >> 3) & ~3
    rows = np.concatenate([rows, np.zeros((h, stride - rows.shape[1]), np.uint8)], 1)
    mask = np.zeros((h, w), bool) if mask is None else mask
    mrows = np.packbits(mask.astype(np.uint8), axis=1)
    mstride = ((w + 31) // 32) * 4
    mrows = np.concatenate([mrows, np.zeros((h, mstride - mrows.shape[1]), np.uint8)], 1)
    header = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, 0, 0, 0,
                         len(pal) // 4, 0)
    return header + pal + rows[::-1].tobytes() + mrows[::-1].tobytes()


def icon_file(entries, cursor: bool = False, hotspots=None) -> bytes:
    """An ICO (or CUR) of entries: (width, height, bpp, colours, bytes);
    a width or height of 256 is written as 0."""
    out = struct.pack("<HHH", 0, 2 if cursor else 1, len(entries))
    at = 6 + 16 * len(entries)
    body = b""
    for i, (w, h, bpp, ncol, data) in enumerate(entries):
        planes, bits = (1, bpp) if not cursor else (hotspots or [(0, 0)] * len(entries))[i]
        out += struct.pack("<BBBBHHII", w % 256, h % 256, ncol, 0, planes, bits, len(data), at)
        at += len(data)
        body += data
    return out + body


def sgi_rle_file(samples: np.ndarray, bpc: int = 1, dimension: int = 3) -> bytes:
    """An RLE SGI image of `samples` [h, w, z] (high byte first at 2 bytes),
    rows bottom-up, runs of up to 127 (repeats of 3 or more, literals
    otherwise), the tables after the 512-byte header."""
    h, w, z = samples.shape
    rows, starts, lengths = [], [], []
    at = 512 + 8 * h * z
    for c in range(z):
        for y in range(h):
            row = samples[h - 1 - y, :, c].astype(">u2" if bpc == 2 else np.uint8)
            vals = [row[i:i + 1].tobytes() for i in range(w)]
            out, i = bytearray(), 0
            while i < w:
                j = i
                while j + 1 < w and vals[j + 1] == vals[i] and j - i < 126:
                    j += 1
                if j - i + 1 >= 3:
                    out += (j - i + 1).to_bytes(bpc, "big") + vals[i]
                    i = j + 1
                    continue
                j = i
                while j < w and j - i < 127 and not (j + 2 < w and vals[j] == vals[j + 1]
                                                      == vals[j + 2]):
                    j += 1
                out += (0x80 | (j - i)).to_bytes(bpc, "big") + b"".join(vals[i:j])
                i = j
            out += bytes(bpc)
            starts.append(at)
            lengths.append(len(out))
            at += len(out)
            rows.append(bytes(out))
    head = struct.pack(">HBBHHHH", 474, 1, bpc, dimension, w, h, z).ljust(512, b"\0")
    return (head + b"".join(struct.pack(">I", v) for v in starts)
            + b"".join(struct.pack(">I", v) for v in lengths) + b"".join(rows))


def tga_rle_bytes(rows: np.ndarray, depth: int) -> bytes:
    """Targa RLE of rows [h, w * depth] of `depth`-byte pixels: runs of 2 or
    more equal pixels, literal packets otherwise, packets within a row."""
    out = bytearray()
    for row in rows:
        px = [row[i:i + depth].tobytes() for i in range(0, len(row), depth)]
        i = 0
        while i < len(px):
            j = i
            while j + 1 < len(px) and px[j + 1] == px[i] and j - i < 127:
                j += 1
            if j > i:
                out += bytes([0x80 | (j - i)]) + px[i]
                i = j + 1
                continue
            j = i
            while j < len(px) and j - i < 128 and not (j + 1 < len(px) and px[j + 1] == px[j]):
                j += 1
            j = max(j, i + 1)
            out += bytes([j - i - 1]) + b"".join(px[i:j])
            i = j
    return bytes(out)


def tga_file(indices: np.ndarray, colormap=None, map_depth: int = 24, map_start: int = 0,
             rle: bool = False, origin: int = 0x00, image_id: bytes = b"",
             depth: int = 8, imagetype: int = None) -> bytes:
    """A Targa file: colour-mapped ([h, w] indices over `colormap` [n, 3|4]
    RGB(A), stored from index `map_start` at 16, 24 or 32 bits), or, without
    a map, `indices` as stored pixels ([h, w] grey, [h, w, k] bytes in file
    order); rows bottom-up unless `origin` has bit 5, RLE at will."""
    h, w = indices.shape[:2]
    cmap = b""
    if colormap is not None:
        cm = np.asarray(colormap, np.uint8)
        if map_depth == 16:
            v = ((cm[:, 0].astype(np.uint16) >> 3) << 10) | ((cm[:, 1].astype(np.uint16) >> 3)
                                                            << 5) | (cm[:, 2] >> 3)
            cmap = v.astype("<u2").tobytes()
        else:
            order = [2, 1, 0, 3] if map_depth == 32 else [2, 1, 0]
            if cm.shape[1] == 3 and map_depth == 32:
                cm = np.concatenate([cm, np.full((len(cm), 1), 255, np.uint8)], 1)
            cmap = cm[:, order].tobytes()
        imagetype = imagetype or 1
        depth = 8
    else:
        imagetype = imagetype or (3 if indices.ndim == 2 else 2)
    nbytes = max(depth // 8, 1)
    rows = indices.reshape(h, -1).astype(np.uint8)
    rows = rows if origin & 0x20 else rows[::-1]
    if rle:
        imagetype |= 8
    data = tga_rle_bytes(rows, nbytes) if rle else rows.tobytes()
    ncol = len(colormap) if colormap is not None else 0
    head = struct.pack("<BBBHHBHHHHBB", len(image_id), 1 if ncol else 0, imagetype,
                       map_start if ncol else 0, ncol, map_depth if ncol else 0, 0, 0, w, h,
                       depth, origin)
    return head + image_id + cmap + data


def dds_file(width: int, height: int, payload: bytes, pfflags: int = 0x4, fourcc: bytes = b"",
             bitcount: int = 0, masks=(0, 0, 0, 0), dxgi: int = None,
             palette: bytes = b"") -> bytes:
    """A DDS file: the 124-byte header (pixel format flags, FOURCC, bit
    count, masks), the DX10 header with `dxgi` when given (FOURCC DX10),
    then `palette` and `payload`."""
    fourcc = b"DX10" if dxgi is not None else fourcc
    head = struct.pack("<4s7I44x", b"DDS ", 124, 0x1007, height, width, 0, 0, 1)
    head += struct.pack("<II4sI4I", 32, pfflags, fourcc.ljust(4, b"\0"), bitcount, *masks)
    head += struct.pack("<5I", 0x1000, 0, 0, 0, 0)
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head + palette + payload


def _mips(start: int, mips) -> tuple:
    """(offsets + lengths table, data) of mips stored from byte `start`."""
    offsets, at = [], start
    for m in mips:
        offsets.append(at)
        at += len(m)
    pad = [0] * (16 - len(mips))
    return (struct.pack("<16I", *offsets, *pad) + struct.pack("<16I", *map(len, mips), *pad),
            b"".join(mips))


def blp1_file(width: int, height: int, compression: int, alpha_bits: int, mips,
              palette: bytes = b"", jpeg_header: bytes = b"", encoding: int = 5) -> bytes:
    """A BLP1 file: JPEG (compression 0: the shared `jpeg_header`, then
    each mip's rest of the stream) or palette (1: the 1024-byte BGRA
    `palette`, then each mip's indices)."""
    head = b"BLP1" + struct.pack("<iIIIiI", compression, alpha_bits, width, height, encoding, 0)
    extra = struct.pack("<I", len(jpeg_header)) + jpeg_header if compression == 0 else palette
    table, data = _mips(28 + 128 + len(extra), mips)
    return head + table + extra + data


def blp2_file(width: int, height: int, encoding: int, alpha_depth: int, alpha_encoding: int,
              mips, palette: bytes = bytes(1024)) -> bytes:
    """A BLP2 file: encoding 1 (palette indices) or 2 (DXT, by
    `alpha_encoding` 0, 1 or 7) after the 1024-byte BGRA `palette`."""
    head = b"BLP2" + struct.pack("<ibbbbII", 1, encoding, alpha_depth, alpha_encoding, 1, width,
                                 height)
    table, data = _mips(20 + 128 + len(palette), mips)
    return head + table + palette + data


def ftex_file(width: int, height: int, fmt: int, mip: bytes, formats: int = 1) -> bytes:
    """An FTEX file of one mip: format 0 (DXT1) or 1 (raw RGB)."""
    return (b"FTEX" + struct.pack("<5i", 0, width, height, 1, formats)
            + struct.pack("<2i", fmt, 32) + struct.pack("<i", len(mip)) + mip)
