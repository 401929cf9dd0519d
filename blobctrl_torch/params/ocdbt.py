"""OCDBT, the key-value store under the JAX package's orbax checkpoints,
read and written without tensorstore (which neither machine of the port
has).

A database is a directory: ``manifest.ocdbt`` names the versions of a
b-tree whose nodes and large values live in data files (``d/<hex>``, or
under ``ocdbt.process_N/`` where several processes wrote). Each manifest,
b-tree node and version-tree node is a file range that starts with a magic
number, its length and its compression (zstd), and ends in a CRC-32C of
all before it, which ``Store`` verifies. ``Store`` reads the newest
version: the manifest's inline versions, or its version tree when those
are empty; interior and leaf nodes with their shared key prefixes, data
file paths inherited down the tree; values inline in a leaf or indirect
(a data file, an offset, a length). ``write`` makes a database of one
version: leaf and interior nodes each under ``max_decoded_node_bytes``,
values above ``max_inline_value_bytes`` indirect in data files, and every
zstd frame made of raw blocks (valid zstd; no encoder needed).

The compiled decoder (``csrc/zstd_decode.cpp``, built by
``ops._build.host_entry``) undoes the zstd of nodes and values; its
ctypes calls release the GIL, so values can be decoded on several
threads. ``utils/zstd.py`` is its plain version.
"""

from __future__ import annotations

import contextlib
import mmap
import os
import struct
import threading
import time
import uuid
from typing import (Dict, Iterable, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np

from blobctrl_torch.ops import _build

MANIFEST_MAGIC, BTREE_MAGIC, VERSION_MAGIC = 0x0CDB3A2A, 0x0CDB20DE, \
    0x0CDB1234
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
DATA_FILE_BYTES = 1 << 30        # a new data file past this many bytes
_ZSTD_ERRORS = {-1: "truncated", -2: "corrupt", -3: "needs a dictionary",
                -4: "larger than its buffer", -5: "window too large",
                -6: "not zstd data", -7: "content checksum mismatch"}
_RAW_BLOCK = 128 * 1024


# ---------------------------------------------------------------------------
# zstd (the compiled decoder) and CRC-32C
# ---------------------------------------------------------------------------

def _address(buf) -> Tuple[int, int]:
    """(address, bytes) of a contiguous buffer (bytes, bytearray, numpy)."""
    arr = np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) \
        else buf.reshape(-1).view(np.uint8)
    return arr.ctypes.data, arr.nbytes


def zstd_content_size(data) -> Optional[int]:
    """The decoded size the frames of ``data`` declare, or None where a
    frame declares none."""
    addr, n = _address(data)
    got = _build.host_entry("zstd_content_size")(addr, n)
    if got == -100:
        return None
    if got < 0:
        raise ValueError(f"zstd data {_ZSTD_ERRORS.get(got, got)}")
    return int(got)


def zstd_decompress(data, out: Optional[np.ndarray] = None,
                    limit: int = 1 << 40):
    """Decode every zstd frame of ``data`` with the compiled decoder.
    With ``out`` (a contiguous numpy array) the bytes go straight into it
    and must fill it exactly; else -> a new uint8 array (at most ``limit``
    bytes). Raises ValueError on a dictionary, truncation or corruption."""
    src, n = _address(data)
    fn = _build.host_entry("zstd_decompress")
    if out is not None:
        dst, cap = _address(out)
        got = fn(src, n, dst, cap)
        if got < 0:
            raise ValueError(f"zstd data {_ZSTD_ERRORS.get(got, got)}")
        if got != cap:
            raise ValueError(f"zstd data decodes to {got} bytes, "
                             f"{cap} expected")
        return out
    size = zstd_content_size(data)
    cap = size if size is not None else max(4 * n, 1 << 16)
    while True:
        if cap > limit:
            raise ValueError(f"zstd data decodes past {limit} bytes")
        buf = np.empty(max(cap, 1), np.uint8)
        got = fn(src, n, buf.ctypes.data, cap)
        if got == -4 and size is None:
            cap *= 4
            continue
        if got < 0:
            raise ValueError(f"zstd data {_ZSTD_ERRORS.get(got, got)}")
        return buf[:got]


def crc32c(data) -> int:
    addr, n = _address(data)
    return int(_build.host_entry("crc32c")(addr, n, 0))


def zstd_raw_frame(data) -> List[memoryview]:
    """``data`` as one zstd frame of raw blocks (its content size
    declared, no checksum), as a list of buffers to write one after
    another: no copy of ``data`` is made."""
    view = memoryview(data).cast("B")
    n = len(view)
    # single segment (the window is the content), an 8-byte content size
    parts = [memoryview(struct.pack("<IBQ", 0xFD2FB528, 0xE0, n))]
    pos = 0
    while True:
        size = min(_RAW_BLOCK, n - pos)
        last = pos + size == n
        parts.append(memoryview(((size << 3) | int(last)).to_bytes(3,
                                                                   "little")))
        if size:
            parts.append(view[pos:pos + size])
        pos += size
        if last:
            return parts


# ---------------------------------------------------------------------------
# encodings
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def _need(self, n):
        if self.pos + n > len(self.data):
            raise ValueError(f"OCDBT {self.what}: truncated")

    def u8(self) -> int:
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.u8()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError(f"OCDBT {self.what}: bad varint")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.raw(8 * n)))

    def end(self):
        if self.pos != len(self.data):
            raise ValueError(f"OCDBT {self.what}: {len(self.data) - self.pos}"
                             f" bytes after its end")


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(vs) -> bytes:
    return b"".join(_varint(v) for v in vs)


def _common(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _prefix_coded(r: _Reader, n: int) -> List[bytes]:
    """n byte strings, each stored as its prefix shared with the one
    before (from the second on), its suffix length, then the suffixes."""
    shared = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    out = []
    for i in range(n):
        if shared[i] > (len(out[-1]) if out else 0):
            raise ValueError(f"OCDBT {r.what}: bad key prefix")
        out.append((out[-1][:shared[i]] if i else b"") + r.raw(suffix[i]))
    return out


def _encode_prefix_coded(items: Sequence[bytes]) -> Tuple[bytes, bytes,
                                                          bytes]:
    """-> (shared lengths from the second on, suffix lengths, suffixes)."""
    shared = [_common(items[i - 1], items[i]) for i in range(1, len(items))]
    full = [0] + shared
    return (_varints(shared), _varints(len(k) - s for k, s in
                                       zip(items, full)),
            b"".join(k[s:] for k, s in zip(items, full)))


def _unframe(blob: bytes, magic: int, what: str) -> bytes:
    """A manifest or node file range -> its body, the magic, length,
    version and CRC-32C checked, zstd undone."""
    if len(blob) < 18:
        raise ValueError(f"OCDBT {what}: truncated")
    (m,) = struct.unpack(">I", blob[:4])
    if m != magic:
        raise ValueError(f"OCDBT {what}: magic {m:#010x}, {magic:#010x} "
                         f"expected")
    (length,) = struct.unpack("<Q", blob[4:12])
    if length != len(blob):
        raise ValueError(f"OCDBT {what}: {len(blob)} bytes, the header "
                         f"says {length}")
    (crc,) = struct.unpack("<I", blob[-4:])
    if crc32c(blob[:-4]) != crc:
        raise ValueError(f"OCDBT {what}: CRC-32C mismatch")
    r = _Reader(blob[:-4], what)
    r.pos = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise ValueError(f"OCDBT {what}: format version {version}")
    body = blob[r.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd_decompress(body, limit=MAX_DECODED_NODE_BYTES * 2
                               ).tobytes()
    raise ValueError(f"OCDBT {what}: compression {compression}")


def _frame(magic: int, body: bytes) -> bytes:
    """The inverse of ``_unframe``: the body as zstd raw blocks."""
    payload = b"".join(zstd_raw_frame(body))
    head = struct.pack(">I", magic)
    rest = b"\x00\x01" + payload      # format version 0, zstd
    blob = head + struct.pack("<Q", 4 + 8 + len(rest) + 4) + rest
    return blob + struct.pack("<I", crc32c(blob))


class Loc(NamedTuple):
    """A file range: the data file is ``prefix + base + rel`` below the
    database's root, where ``prefix`` is what the nodes above passed down
    (the base paths of the references that led here) and ``base`` and
    ``rel`` are the node's or manifest's own entry; a node reached through
    it passes ``prefix + base`` on to its own entries."""
    prefix: str
    base: str
    rel: str
    offset: int
    length: int

    @property
    def path(self) -> str:
        return self.prefix + self.base + self.rel

    def dump(self, kind: str) -> str:
        """As tensorstore's ``ocdbt.dump`` writes a location."""
        return f"{kind}:{self.base}:{self.rel}:{self.offset}:{self.length}"


def _read_file_table(r: _Reader) -> List[Tuple[str, str]]:
    """-> [(base path, relative path)] of a node's or manifest's data
    files (each stored whole, prefix-coded against the one before)."""
    n = r.varint()
    shared = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base = r.varints(n)
    out, prev = [], b""
    for i in range(n):
        if shared[i] > len(prev):
            raise ValueError(f"OCDBT {r.what}: bad data file path prefix")
        full = prev[:shared[i]] + r.raw(suffix[i])
        if base[i] > len(full):
            raise ValueError(f"OCDBT {r.what}: bad data file base path")
        out.append((full[:base[i]].decode(), full[base[i]:].decode()))
        prev = full
    return out


def _encode_file_table(paths: Sequence[str]) -> bytes:
    enc = [p.encode() for p in paths]
    shared, suffix, raw = _encode_prefix_coded(enc)
    return (_varint(len(enc)) + shared + suffix + bytes(len(enc)) + raw)


_CONFIG_KEYS = ("uuid", "manifest_kind", "max_inline_value_bytes",
                "max_decoded_node_bytes", "version_tree_arity_log2",
                "compression")


def _read_config(r: _Reader) -> dict:
    cfg = {"uuid": r.raw(16).hex(), "manifest_kind": r.varint(),
           "max_inline_value_bytes": r.varint(),
           "max_decoded_node_bytes": r.varint(),
           "version_tree_arity_log2": r.u8()}
    method = r.varint()
    if method == 0:
        cfg["compression"] = None
    elif method == 1:
        (level,) = struct.unpack("<i", r.raw(4))
        cfg["compression"] = {"id": "zstd", "level": level}
    else:
        raise ValueError(f"OCDBT {r.what}: compression method {method}")
    return cfg


def _read_versions(r: _Reader, files, prefix: str = "") -> List[dict]:
    n = r.varint()
    gen = r.varints(n)
    height = [r.u8() for _ in range(n)]
    fid, off, length = r.varints(n), r.varints(n), r.varints(n)
    keys, tree, indirect = r.varints(n), r.varints(n), r.varints(n)
    commit = r.u64s(n)
    return [{"generation_number": gen[i], "root_height": height[i],
             "root": _ref(files, fid[i], off[i], length[i], r.what, prefix),
             "num_keys": keys[i], "num_tree_bytes": tree[i],
             "num_indirect_value_bytes": indirect[i],
             "commit_time": commit[i]} for i in range(n)]


def _read_version_refs(r: _Reader, files, heights: bool,
                       prefix: str = "") -> List[dict]:
    n = r.varint()
    gen, fid, off, length = (r.varints(n), r.varints(n), r.varints(n),
                             r.varints(n))
    num, commit = r.varints(n), r.u64s(n)
    height = [r.u8() for _ in range(n)] if heights else [None] * n
    return [{"generation_number": gen[i], "height": height[i],
             "location": _ref(files, fid[i], off[i], length[i], r.what,
                              prefix),
             "num_generations": num[i], "commit_time": commit[i]}
            for i in range(n)]


def _ref(files, fid, off, length, what, prefix: str = "") -> Loc:
    if fid >= len(files):
        raise ValueError(f"OCDBT {what}: data file {fid} of {len(files)}")
    return Loc(prefix, *files[fid], off, length)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _btree_node(blob: bytes, prefix: str):
    """A b-tree node's file range -> (height, entries): a leaf's entries
    are (stored key, bytes | the value's Loc), an interior node's (stored
    key, subtree common prefix length, child Loc, (keys, tree bytes,
    indirect bytes))."""
    r = _Reader(_unframe(blob, BTREE_MAGIC, "b-tree node"), "b-tree node")
    height = r.u8()
    files = _read_file_table(r)
    n = r.varint()
    if height == 0:
        keys = _prefix_coded(r, n)
        lengths = r.varints(n)
        kinds = r.raw(n)
        if any(k > 1 for k in kinds):
            raise ValueError("OCDBT leaf: unknown value kind")
        indirect = [i for i in range(n) if kinds[i]]
        fids, offs = r.varints(len(indirect)), r.varints(len(indirect))
        values: List[object] = [None] * n
        for i, fid, off in zip(indirect, fids, offs):
            values[i] = _ref(files, fid, off, lengths[i], r.what, prefix)
        for i in range(n):
            if not kinds[i]:
                values[i] = r.raw(lengths[i])
        r.end()
        return 0, list(zip(keys, values))
    shared = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n)
    keys = []
    for i in range(n):
        if shared[i] > (len(keys[-1]) if keys else 0):
            raise ValueError("OCDBT b-tree node: bad key prefix")
        keys.append((keys[-1][:shared[i]] if i else b"") + r.raw(suffix[i]))
    fids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
    stats = list(zip(r.varints(n), r.varints(n), r.varints(n)))
    r.end()
    return height, [(keys[i], common[i],
                     _ref(files, fids[i], offs[i], lens[i], r.what, prefix),
                     stats[i]) for i in range(n)]


class Store:
    """The newest version of the OCDBT database at ``root``: ``keys()``,
    ``get(key)`` (bytes), ``location(key)`` and ``read(path, offset,
    length)`` for the indirect values; ``dump()`` and ``dump_node(loc)``
    give the manifest and a b-tree node as tensorstore's ``ocdbt.dump``
    does. Every node's checksum is verified and each subtree's key count
    checked as it is read."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._fds: Dict[str, int] = {}
        self._lock = threading.Lock()
        path = os.path.join(self.root, "manifest.ocdbt")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no OCDBT manifest in {self.root}")
        with open(path, "rb") as f:
            body = _unframe(f.read(), MANIFEST_MAGIC, "manifest")
        r = _Reader(body, "manifest")
        self.config = _read_config(r)
        if self.config["manifest_kind"] != 0:
            raise ValueError("OCDBT manifest of the numbered kind: not "
                             "supported (orbax writes the single kind)")
        files = _read_file_table(r)
        self.versions = _read_versions(r, files)
        self.version_tree_nodes = _read_version_refs(r, files, True)
        r.end()
        newest = self._newest()
        self.generation = newest["generation_number"]
        # key -> bytes (inline) or its Loc (indirect)
        self._values: Dict[bytes, object] = {}
        if newest["num_keys"]:
            got = self._walk(newest["root"], newest["root_height"], b"")
            if got != newest["num_keys"]:
                raise ValueError(f"OCDBT: {got} keys, the manifest says "
                                 f"{newest['num_keys']}")
        self._sorted = sorted(self._values)

    def _newest(self) -> dict:
        if self.versions:
            return max(self.versions, key=lambda v: v["generation_number"])
        if not self.version_tree_nodes:
            raise ValueError("OCDBT manifest without a version")
        ref = max(self.version_tree_nodes,
                  key=lambda v: v["generation_number"])
        height = ref["height"]
        while True:
            loc = ref["location"]
            r = _Reader(_unframe(self._range(loc), VERSION_MAGIC,
                                 "version node"), "version node")
            r.u8()                                   # arity log2
            if r.u8() != height:
                raise ValueError("OCDBT version node of another height")
            files = _read_file_table(r)
            prefix = loc.prefix + loc.base
            if height == 0:
                versions = _read_versions(r, files, prefix)
                r.end()
                return max(versions, key=lambda v: v["generation_number"])
            refs = _read_version_refs(r, files, False, prefix)
            r.end()
            ref = max(refs, key=lambda v: v["generation_number"])
            height -= 1

    def _fd(self, path: str) -> int:
        with self._lock:
            if path not in self._fds:
                full = os.path.join(self.root, path)
                if not os.path.realpath(full).startswith(self.root + os.sep):
                    raise ValueError(f"OCDBT data file {path!r} outside "
                                     f"the database")
                self._fds[path] = os.open(full, os.O_RDONLY)
            return self._fds[path]

    def read(self, path: str, offset: int, length: int) -> bytes:
        """``length`` bytes of data file ``path`` from ``offset``."""
        data = os.pread(self._fd(path), length, offset)
        if len(data) != length:
            raise ValueError(f"OCDBT data file {path}: truncated")
        return data

    def _range(self, loc: Loc) -> bytes:
        return self.read(loc.path, loc.offset, loc.length)

    @contextlib.contextmanager
    def mapped(self, key: bytes):
        """A key's value as a uint8 array without a copy: the inline bytes,
        or the data file's range mapped from the page cache (unmapped on
        exit, so the caller must drop its views by then)."""
        v = self._values[key]
        if isinstance(v, bytes):
            yield np.frombuffer(v, np.uint8)
            return
        page = mmap.ALLOCATIONGRANULARITY
        start = v.offset - v.offset % page
        mm = mmap.mmap(self._fd(v.path), v.offset + v.length - start,
                       access=mmap.ACCESS_READ, offset=start)
        try:
            view = np.frombuffer(mm, np.uint8, v.length, v.offset - start)
            yield view
            del view
        finally:
            try:
                mm.close()
            except BufferError:   # a view outlived the block: left to GC
                pass

    def _walk(self, loc: Loc, height: int, prefix: bytes) -> int:
        """Read the subtree at ``loc`` (keys under ``prefix``) into
        ``_values`` -> its number of keys."""
        h, entries = _btree_node(self._range(loc), loc.prefix + loc.base)
        if h != height:
            raise ValueError("OCDBT b-tree node of another height")
        if h == 0:
            for key, value in entries:
                self._values[prefix + key] = value
            return len(entries)
        total = 0
        for key, common, child, (nkeys, _, _) in entries:
            got = self._walk(child, h - 1, prefix + key[:common])
            if got != nkeys:
                raise ValueError(f"OCDBT: a subtree holds {got} keys, its "
                                 f"parent says {nkeys}")
            total += got
        return total

    def dump(self) -> dict:
        """The manifest as ``tensorstore.ocdbt.dump(base)`` gives it."""
        cfg = dict(self.config)
        del cfg["manifest_kind"]
        comp = cfg["compression"]
        if comp is not None and comp["level"] == 0:
            cfg["compression"] = {"id": comp["id"]}
        return {
            "config": cfg,
            "versions": [{
                "commit_time": v["commit_time"],
                "generation_number": v["generation_number"],
                "root": {"location": v["root"].dump("btreenode"),
                         "statistics": {
                             "num_indirect_value_bytes":
                                 v["num_indirect_value_bytes"],
                             "num_keys": v["num_keys"],
                             "num_tree_bytes": v["num_tree_bytes"]}},
                "root_height": v["root_height"]} for v in self.versions],
            "version_tree_nodes": [{
                "commit_time": v["commit_time"],
                "generation_number": v["generation_number"],
                "height": v["height"],
                "location": v["location"].dump("versionnode"),
                "num_generations": v["num_generations"]}
                for v in self.version_tree_nodes]}

    def dump_node(self, loc: Loc) -> dict:
        """A b-tree node as ``tensorstore.ocdbt.dump(base, location)``
        gives it."""
        height, entries = _btree_node(self._range(loc), loc.prefix + loc.base)
        if height == 0:
            return {"height": 0, "entries": [
                {"key": k, "inline_value": v} if isinstance(v, bytes) else
                {"key": k, "indirect_value": v.dump("value")}
                for k, v in entries]}
        return {"height": height, "entries": [
            {"key": k, "location": child.dump("btreenode"),
             "statistics": {"num_indirect_value_bytes": ind,
                            "num_keys": nkeys, "num_tree_bytes": tree},
             "subtree_common_prefix": k[:common]}
            for k, common, child, (nkeys, tree, ind) in entries]}

    def keys(self) -> List[bytes]:
        return list(self._sorted)

    def __contains__(self, key: bytes) -> bool:
        return key in self._values

    def location(self, key: bytes):
        """bytes (an inline value) or its Loc (data file, offset,
        length)."""
        return self._values[key]

    def get(self, key: bytes) -> bytes:
        v = self._values[key]
        return v if isinstance(v, bytes) else self._range(v)

    def close(self):
        with self._lock:
            for fd in self._fds.values():
                os.close(fd)
            self._fds.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _leaf_body(entries, files: List[str]) -> bytes:
    """entries: [(key, bytes | (file, offset, length))] -> a leaf body."""
    keys = [k for k, _ in entries]
    shared, suffix, raw = _encode_prefix_coded(keys)
    lengths = [len(v) if isinstance(v, bytes) else v[2] for _, v in entries]
    kinds = bytes(0 if isinstance(v, bytes) else 1 for _, v in entries)
    ind = [v for _, v in entries if not isinstance(v, bytes)]
    fidx = {p: i for i, p in enumerate(files)}
    return (b"\x00" + _encode_file_table(files) + _varint(len(entries))
            + shared + suffix + raw + _varints(lengths) + kinds
            + _varints(fidx[v[0]] for v in ind)
            + _varints(v[1] for v in ind)
            + b"".join(v for _, v in entries if isinstance(v, bytes)))


def _interior_body(height: int, children, files: List[str]) -> bytes:
    """children: [(first key, (file, offset, length), stats)] with stats
    (keys, tree bytes, indirect bytes); no common prefix is factored out,
    so the children store their keys whole."""
    keys = [k for k, _, _ in children]
    shared, suffix, raw = _encode_prefix_coded(keys)
    fidx = {p: i for i, p in enumerate(files)}
    return (bytes([height]) + _encode_file_table(files)
            + _varint(len(children)) + shared + suffix
            + bytes(len(children)) + raw
            + _varints(fidx[loc[0]] for _, loc, _ in children)
            + _varints(loc[1] for _, loc, _ in children)
            + _varints(loc[2] for _, loc, _ in children)
            + b"".join(_varints(s[j] for _, _, s in children)
                       for j in range(3)))


def _groups(items, size_of, limit: int, least: int = 1):
    """Consecutive groups whose summed size estimate stays under limit
    (``least`` items a group whatever their size)."""
    group, total = [], 0
    for it in items:
        s = size_of(it)
        if len(group) >= least and total + s > limit:
            yield group
            group, total = [], 0
        group.append(it)
        total += s
    if group:
        yield group


def _writev(fd: int, parts) -> None:
    """Every buffer of ``parts`` written in order, many a system call."""
    views = [memoryview(p).cast("B") for p in parts]
    views = [v for v in views if len(v)]
    limit = min(os.sysconf("SC_IOV_MAX"), 1024)
    while views:
        done = os.writev(fd, views[:limit])
        while done:
            if done >= len(views[0]):
                done -= len(views.pop(0))
            else:
                views[0] = views[0][done:]
                done = 0


def write(root: str, values: Iterable[Tuple[bytes, object]],
          max_inline_value_bytes: int = MAX_INLINE_VALUE_BYTES,
          max_decoded_node_bytes: int = MAX_DECODED_NODE_BYTES,
          data_file_bytes: int = DATA_FILE_BYTES) -> None:
    """Write a one-version OCDBT database at ``root`` (created; it must
    not hold one yet). ``values``: (key, value) pairs, each value bytes or
    a list of buffers written one after another (``zstd_raw_frame``'s
    output); above ``max_inline_value_bytes`` a value goes into a data
    file. Everything is written under ``d/``; the manifest last."""
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    if os.path.exists(os.path.join(root, "manifest.ocdbt")):
        raise FileExistsError(f"an OCDBT database exists in {root}")
    entries, indirect_bytes = [], 0
    out = {"f": None, "path": None, "size": 0}

    def data_file():
        if out["f"] is None or out["size"] >= data_file_bytes:
            if out["f"] is not None:
                os.close(out["f"])
            out["path"] = f"d/{uuid.uuid4().hex}"
            out["f"] = os.open(os.path.join(root, out["path"]),
                               os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644)
            out["size"] = 0
        return out["f"], out["path"]

    seen = set()
    try:
        for key, value in values:
            if key in seen:
                raise ValueError(f"OCDBT write: key {key!r} twice")
            seen.add(key)
            parts = [value] if isinstance(value, (bytes, bytearray,
                                                  memoryview)) else value
            n = sum(memoryview(p).nbytes for p in parts)
            if n <= max_inline_value_bytes:
                entries.append((key, b"".join(bytes(p) for p in parts)))
                continue
            fd, path = data_file()
            _writev(fd, parts)
            entries.append((key, (path, out["size"], n)))
            out["size"] += n
            indirect_bytes += n
    finally:
        if out["f"] is not None:
            os.close(out["f"])
    if not entries:
        raise ValueError("OCDBT write: no values")
    entries.sort(key=lambda e: e[0])

    node_path = f"d/{uuid.uuid4().hex}"
    with open(os.path.join(root, node_path), "wb") as nf:
        pos = 0

        def put(blob):
            nonlocal pos
            nf.write(blob)
            pos += len(blob)
            return (node_path, pos - len(blob), len(blob))

        budget = max_decoded_node_bytes * 3 // 4     # tables, counts
        level = []
        for group in _groups(entries, lambda e: len(e[0]) + 24 + (
                len(e[1]) if isinstance(e[1], bytes) else 0), budget):
            files = sorted({v[0] for _, v in group
                            if not isinstance(v, bytes)})
            loc = put(_frame(BTREE_MAGIC, _leaf_body(group, files)))
            ind = sum(v[2] for _, v in group if not isinstance(v, bytes))
            level.append((group[0][0], loc, (len(group), loc[2], ind)))
        height = 0
        while len(level) > 1:
            height += 1
            nxt = []
            for group in _groups(level, lambda c: len(c[0]) + 48, budget,
                                 2):
                files = sorted({loc[0] for _, loc, _ in group})
                loc = put(_frame(BTREE_MAGIC,
                                 _interior_body(height, group, files)))
                stats = tuple(sum(s[j] for _, _, s in group)
                              for j in range(3))
                nxt.append((group[0][0], loc,
                            (stats[0], stats[1] + loc[2], stats[2])))
            level = nxt
    _, root_loc, (nkeys, tree_bytes, ind_bytes) = level[0]
    assert ind_bytes == indirect_bytes
    body = (uuid.uuid4().bytes + _varint(0)
            + _varint(max_inline_value_bytes)
            + _varint(max_decoded_node_bytes)
            + bytes([VERSION_TREE_ARITY_LOG2]) + _varint(1)
            + struct.pack("<i", 0)
            + _encode_file_table([node_path])
            + _varint(1) + _varint(1) + bytes([height]) + _varint(0)
            + _varint(root_loc[1]) + _varint(root_loc[2]) + _varint(nkeys)
            + _varint(tree_bytes) + _varint(ind_bytes)
            + struct.pack("<Q", time.time_ns()) + _varint(0))
    tmp = os.path.join(root, "manifest.ocdbt.tmp")
    with open(tmp, "wb") as f:
        f.write(_frame(MANIFEST_MAGIC, body))
    os.replace(tmp, os.path.join(root, "manifest.ocdbt"))
