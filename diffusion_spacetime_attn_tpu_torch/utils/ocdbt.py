"""A read-only reader of tensorstore's OCDBT key-value databases, in which
orbax stores checkpoints (`"use_ocdbt": true`).

`Database(path).keys()` and `.read(key)` give what tensorstore's `ocdbt`
kvstore gives for the newest version; `.versions()` lists every version the
manifest reaches (inline ones and those in version-tree nodes).  The file
layout, as tensorstore writes it and as its `ocdbt.dump` decodes it:

* every manifest, b-tree node and version-tree node starts with a 4-byte
  big-endian magic (0x0cdb3a2a, 0x0cdb20de, 0x0cdb1234), the little-endian
  u64 length of the whole encoded object, a version varint (0) and a
  compression varint (0 none, 1 zstd), then the (zstd) body, then the
  little-endian CRC-32C of everything before it;
* a body lists its data files once (a prefix-coded path table) and refers
  to them by index; integers are LEB128 varints unless noted, and every
  per-entry field is stored as one column over the entries;
* the manifest holds the config (uuid, manifest kind, the inline and node
  size limits, the version-tree arity, the compression and its level as a
  little-endian i32), the newest versions inline (generation, root height,
  root location, statistics, commit time as a little-endian u64) and
  references to version-tree nodes;
* a b-tree node holds its height, prefix-coded keys (an interior entry also
  the length of the prefix its whole subtree shares, which the child's keys
  omit) and, for a leaf, each value's length, kind (0 inline, 1 indirect)
  and the data file and offset of the indirect ones, then the inline values.

Root and node locations are (data file, offset, length) slices of files under
the database directory.  Only the root manifest (`manifest.ocdbt`, which
orbax writes when it merges the per-process databases) is read: a checkpoint
holding only `ocdbt.process_*/` databases was not finished, and raises.
Corrupt files raise `ValueError`.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, NamedTuple, Optional

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_MAGIC = 0x0CDB1234
_NONE = (1 << 64) - 1                  # offset and length of an absent root


class Ref(NamedTuple):
    """A slice of a data file: the file's path under the database, offset, length."""
    path: str
    offset: int
    length: int


class Version(NamedTuple):
    generation: int
    root_height: int
    root: Optional[Ref]
    num_keys: int
    commit_time: int


class _Reader:
    """Forward reads over a node's decoded body."""

    def __init__(self, data: bytes, what: str):
        self.d, self.p, self.what = data, 0, what

    def fail(self, why: str):
        raise ValueError(f"{self.what}: corrupt OCDBT data ({why})")

    def varint(self) -> int:
        v = shift = 0
        while True:
            if self.p >= len(self.d):
                self.fail("truncated varint")
            b = self.d[self.p]
            self.p += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
            if shift > 63:
                self.fail("varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if n < 0 or self.p + n > len(self.d):
            self.fail("truncated")
        b = self.d[self.p:self.p + n]
        self.p += n
        return b

    def u8s(self, n: int) -> List[int]:
        return list(self.take(n))

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.take(8 * n)))

    def end(self):
        if self.p != len(self.d):
            self.fail(f"{len(self.d) - self.p} bytes left over")


def _decode_object(raw: bytes, magic: int, what: str) -> bytes:
    """The body of one encoded manifest or node, its header and CRC checked."""
    if len(raw) < 18:
        raise ValueError(f"{what}: truncated OCDBT object ({len(raw)} bytes)")
    got_magic, length = struct.unpack(">I", raw[:4])[0], struct.unpack("<Q", raw[4:12])[0]
    if got_magic != magic:
        raise ValueError(f"{what}: bad OCDBT magic {got_magic:#010x}, expected {magic:#010x}")
    if length != len(raw):
        raise ValueError(f"{what}: OCDBT object says {length} bytes, has {len(raw)}")
    if zstd.crc32c(raw[:-4]) != struct.unpack("<I", raw[-4:])[0]:
        raise ValueError(f"{what}: OCDBT checksum mismatch")
    r = _Reader(raw[:-4], what)
    r.p = 12
    if r.varint() != 0:
        r.fail("unknown format version")
    comp = r.varint()
    body = raw[r.p:-4]
    if comp == 0:
        return body
    if comp == 1:
        return zstd.decompress(body, name=what)
    raise ValueError(f"{what}: unknown OCDBT compression {comp}")


def _file_table(r: _Reader) -> List[str]:
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)                       # base-path lengths: the paths are whole already
    paths: List[str] = []
    for i in range(n):
        if prefix[i] > (len(paths[-1]) if paths else 0):
            r.fail("path prefix longer than the previous path")
        head = paths[-1][:prefix[i]] if i else ""
        paths.append(head + r.take(suffix[i]).decode())
    return paths


def _refs(r: _Reader, files: List[str], n: int) -> List[Optional[Ref]]:
    ids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
    out: List[Optional[Ref]] = []
    for i, o, l in zip(ids, offs, lens):
        if i >= len(files):
            r.fail("data file index out of range")
        out.append(None if (o, l) == (_NONE, _NONE) else Ref(files[i], o, l))
    return out


def _versions(r: _Reader, files: List[str]) -> List[Version]:
    n = r.varint()
    gens, heights = r.varints(n), r.u8s(n)
    roots = _refs(r, files, n)
    keys = r.varints(n)
    r.varints(n)                       # num_tree_bytes
    r.varints(n)                       # num_indirect_value_bytes
    times = r.u64s(n)
    return [Version(*v) for v in zip(gens, heights, roots, keys, times)]


def _version_refs(r: _Reader, files: List[str], heights: Optional[int]):
    n = r.varint()
    r.varints(n)                       # generation numbers
    refs = _refs(r, files, n)
    r.varints(n)                       # generations below each
    r.u64s(n)                          # commit times
    hs = r.u8s(n) if heights is None else [heights] * n
    return list(zip(refs, hs))


class Database:
    """The OCDBT database in directory `path` (an orbax checkpoint's root)."""

    def __init__(self, path: str):
        self.path = str(path)
        manifest = os.path.join(self.path, "manifest.ocdbt")
        if not os.path.isfile(manifest):
            parts = sorted(d for d in (os.listdir(self.path) if os.path.isdir(self.path) else [])
                           if d.startswith("ocdbt.process_"))
            if parts:
                raise ValueError(
                    f"{self.path}: no root manifest.ocdbt, only the per-process databases "
                    f"{', '.join(parts)}: the checkpoint was not finished (orbax writes the "
                    "root manifest when it merges them at the end of a save)")
            raise FileNotFoundError(f"{manifest}: not an OCDBT database")
        with open(manifest, "rb") as f:
            body = _decode_object(f.read(), MANIFEST_MAGIC, manifest)
        r = _Reader(body, manifest)
        self.uuid = r.take(16).hex()
        if r.varint() != 0:
            r.fail("numbered manifests are not read")
        self.max_inline_value_bytes = r.varint()
        self.max_decoded_node_bytes = r.varint()
        self.version_tree_arity_log2 = r.u8s(1)[0]
        comp = r.varint()
        if comp == 1:
            r.take(4)                  # zstd level
        elif comp != 0:
            r.fail(f"unknown compression {comp}")
        files = _file_table(r)
        self._inline = _versions(r, files)
        self._nodes = _version_refs(r, files, None)
        r.end()
        if not self._inline:
            r.fail("a manifest without versions")
        self._index: Optional[Dict[bytes, object]] = None

    # -- versions
    def versions(self) -> List[Version]:
        """Every version, oldest first: those in version-tree nodes, then the
        manifest's inline ones."""
        out: List[Version] = []
        for ref, height in self._nodes:
            out.extend(self._walk_versions(ref, height))
        return sorted(out + self._inline, key=lambda v: v.generation)

    def _walk_versions(self, ref: Ref, height: int) -> Iterator[Version]:
        body = _decode_object(self._slice(ref), VERSION_MAGIC, f"{self.path}/{ref.path}")
        r = _Reader(body, ref.path)
        r.u8s(1)                       # arity log2
        if r.u8s(1)[0] != height:
            r.fail("version node height differs from its reference")
        files = _file_table(r)
        if height == 0:
            vs = _versions(r, files)
            r.end()
            yield from vs
            return
        children = _version_refs(r, files, height - 1)
        r.end()
        for cref, h in children:
            yield from self._walk_versions(cref, h)

    @property
    def latest(self) -> Version:
        return self._inline[-1]

    # -- the b-tree
    def _slice(self, ref: Ref) -> bytes:
        full = os.path.normpath(os.path.join(self.path, ref.path))
        if not full.startswith(os.path.normpath(self.path) + os.sep):
            raise ValueError(f"{self.path}: data file {ref.path!r} outside the database")
        with open(full, "rb") as f:
            f.seek(ref.offset)
            b = f.read(ref.length)
        if len(b) != ref.length:
            raise ValueError(f"{full}: truncated (wanted {ref.length} bytes at {ref.offset})")
        return b

    def _node(self, ref: Ref, height: int, prefix: bytes):
        """Entries of one b-tree node: (full key, value) for a leaf, where value
        is bytes or an indirect Ref; (full key, prefix, Ref) for an interior node."""
        body = _decode_object(self._slice(ref), BTREE_MAGIC, f"{self.path}/{ref.path}")
        r = _Reader(body, f"{self.path}/{ref.path}")
        if r.u8s(1)[0] != height:
            r.fail("b-tree node height differs from its reference")
        files = _file_table(r)
        n = r.varint()
        if n == 0:
            r.fail("empty b-tree node")
        plen = [0] + r.varints(n - 1)
        slen = r.varints(n)
        common = r.varints(n) if height > 0 else None
        keys: List[bytes] = []
        for i in range(n):
            if i and plen[i] > len(keys[-1]):
                r.fail("key prefix longer than the previous key")
            keys.append((keys[-1][:plen[i]] if i else b"") + r.take(slen[i]))
        if height > 0:
            children = _refs(r, files, n)
            for _ in range(3):
                r.varints(n)           # the subtrees' statistics
            r.end()
            out = []
            for k, c, ch in zip(keys, common, children):
                if c > len(k) or ch is None:
                    r.fail("bad child reference")
                out.append((prefix + k, prefix + k[:c], ch))
            return out
        lens = r.varints(n)
        kinds = r.u8s(n)
        if any(k > 1 for k in kinds):
            r.fail("unknown value kind")
        n_ind = sum(kinds)
        ids, offs = r.varints(n_ind), r.varints(n_ind)
        vals: List = []
        j = 0
        for kind, ln in zip(kinds, lens):
            if kind:
                if ids[j] >= len(files):
                    r.fail("data file index out of range")
                vals.append(Ref(files[ids[j]], offs[j], ln))
                j += 1
        it = iter(vals)
        out = [(prefix + k, next(it) if kind else r.take(ln))
               for k, kind, ln in zip(keys, kinds, lens)]
        r.end()
        return out

    def _items(self) -> Dict[bytes, object]:
        if self._index is None:
            index: Dict[bytes, object] = {}
            root = self.latest
            if root.root is not None:
                stack = [(root.root, root.root_height, b"")]
                while stack:
                    ref, height, prefix = stack.pop()
                    if height == 0:
                        index.update(self._node(ref, 0, prefix))
                    else:
                        for _, sub, child in self._node(ref, height, prefix):
                            stack.append((child, height - 1, sub))
            self._index = dict(sorted(index.items()))
        return self._index

    def keys(self) -> List[bytes]:
        """Every key of the newest version, in byte order."""
        return list(self._items())

    def __contains__(self, key) -> bool:
        return (key.encode() if isinstance(key, str) else key) in self._items()

    def read(self, key) -> bytes:
        """The value stored at `key` (str or bytes); KeyError when absent."""
        k = key.encode() if isinstance(key, str) else key
        v = self._items().get(k)
        if v is None:
            raise KeyError(f"{self.path}: no key {k!r}")
        return self._slice(v) if isinstance(v, Ref) else v
