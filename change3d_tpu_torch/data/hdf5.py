"""A numpy reader and writer for the subset of HDF5 that LEVIR-CC image
files use, so ``CaptionDataset`` needs no h5py.

The files (``tools/prepare_cc_data.py`` and the reference's preprocessing,
both through h5py's defaults) hold one uint8 dataset ``images`` of shape
[N, 2, 3, H, W] and one scalar integer attribute ``captions_per_image`` on
the root group. With h5py's defaults that is:

- superblock version 0 (offsets and lengths of 8 bytes);
- a root group kept as a symbol table: a version-1 B-tree of symbol-table
  nodes, and a local heap holding the member names;
- version-1 object headers, whose messages may continue in further blocks
  (continuation messages);
- the dataset's dataspace (0x1), datatype (0x3), fill value (0x5) and
  layout (0x8, version 3, contiguous: an address and a size), no filter
  pipeline (0xB);
- attribute messages (0xC) on the root.

``read_file`` walks those structures and returns where the data lies
(``ContiguousArray``, whose ``map`` is an ``np.memmap``: the data itself is
never read here) and the root's attributes. Anything else raises a
``ValueError`` that names what it found: another superblock version
(h5py's ``libver="latest"``), a chunked, compact or virtual layout, a filter
(gzip, shuffle), a type other than uint8, storage never allocated. There is
no fallback to another reader.

``write_file`` writes the same subset (what ``read_file`` reads, and h5py
reads alike): one contiguous uint8 dataset and scalar integer root
attributes.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = 0xFFFFFFFFFFFFFFFF

# Object header message types.
MSG_DATASPACE, MSG_DATATYPE, MSG_FILL = 0x1, 0x3, 0x5
MSG_EXTERNAL, MSG_LAYOUT, MSG_FILTERS, MSG_ATTRIBUTE = 0x7, 0x8, 0xB, 0xC
MSG_CONTINUATION, MSG_SYMBOL_TABLE, MSG_LINK_INFO, MSG_LINK = 0x10, 0x11, 0x2, 0x6

_TYPE_CLASSES = {0: "fixed-point", 1: "floating-point", 2: "time", 3: "string", 4: "bitfield",
                 5: "opaque", 6: "compound", 7: "reference", 8: "enum",
                 9: "variable-length", 10: "array"}
_LAYOUTS = {0: "compact", 1: "contiguous", 2: "chunked", 3: "virtual"}


@dataclasses.dataclass(frozen=True)
class ContiguousArray:
    """Where a contiguous dataset's bytes lie in its file. Small and
    picklable: ``map`` opens the file."""

    path: str
    offset: int
    shape: Tuple[int, ...]
    dtype: str = "uint8"

    def map(self) -> np.memmap:
        """A read-only map of the data; nothing is read until indexed."""
        return np.memmap(self.path, np.dtype(self.dtype), "r", offset=self.offset,
                         shape=self.shape)


def read_file(path: str, name: str = "images") -> Tuple[ContiguousArray, Dict[str, Any]]:
    """(the root member ``name`` as a ``ContiguousArray``, the root's
    attributes) of an HDF5 file in the subset above; ValueError otherwise."""
    with open(path, "rb") as f:
        return _Reader(path, f).read(name)


class _Reader:
    def __init__(self, path: str, f):
        self.path = path
        self.f = f
        self.size = os.fstat(f.fileno()).st_size

    def fail(self, what: str) -> ValueError:
        return ValueError(f"{self.path}: {what}")

    def at(self, addr: int, n: int) -> bytes:
        if addr < 0 or addr + n > self.size:
            raise self.fail(f"truncated: {n} bytes at {addr} lie past the end ({self.size} bytes)")
        self.f.seek(addr)
        return self.f.read(n)

    def uint(self, b: bytes, pos: int, n: int) -> int:
        return int.from_bytes(b[pos:pos + n], "little")

    # -- superblock ---------------------------------------------------------

    def read(self, name: str):
        sb = self._superblock()
        root = self._messages(sb)
        kinds = {t for t, _, _ in root}
        if MSG_SYMBOL_TABLE not in kinds:
            what = "link messages" if kinds & {MSG_LINK_INFO, MSG_LINK} else "no symbol table"
            raise self.fail(f"the root group is not a symbol table ({what}); only the "
                            "symbol-table groups of h5py's default format are read")
        (st,) = [d for t, _, d in root if t == MSG_SYMBOL_TABLE]
        members = self._group(self.uint(st, 0, self.so), self.uint(st, self.so, self.so))
        if name not in members:
            raise self.fail(f"the root group has no member {name!r} (members: "
                            f"{sorted(members)})")
        attrs = dict(self._attribute(d) for t, _, d in root if t == MSG_ATTRIBUTE)
        return self._dataset(name, members[name]), attrs

    def _superblock(self) -> int:
        """Parses the superblock; returns the root object header's address."""
        if self.size < 24 or self.at(0, 8) != SIGNATURE:
            raise self.fail("not an HDF5 file (no signature at its start; a user block is "
                            "not read)")
        head = self.at(0, 24)
        version = head[8]
        if version != 0:
            raise self.fail(f"superblock version {version} (a file written with "
                            "libver='latest' or newer); only version 0, h5py's default, is read")
        self.so, self.sl = head[13], head[14]
        if self.so not in (4, 8) or self.sl not in (4, 8):
            raise self.fail(f"offsets of {self.so} and lengths of {self.sl} bytes; 4 or 8 "
                            "are read")
        self.undefined = (1 << (8 * self.so)) - 1
        b = self.at(24, 4 * self.so + 2 * self.so + 24)
        self.base = self.uint(b, 0, self.so)
        return self.base + self.uint(b, 4 * self.so + self.so, self.so)  # root entry's header

    # -- object headers -----------------------------------------------------

    def _messages(self, addr: int) -> List[Tuple[int, int, bytes]]:
        """(type, flags, data) of every message of the version-1 object
        header at ``addr``, continuation blocks followed."""
        head = self.at(addr, 16)
        if head[0] != 1:
            what = "version 2 (OHDR)" if head[:4] == b"OHDR" else f"version {head[0]}"
            raise self.fail(f"object header at {addr} is {what}; only version 1 is read")
        count = self.uint(head, 2, 2)
        blocks = [(addr + 16, self.uint(head, 8, 4))]
        out = []
        while blocks and len(out) < count:
            start, length = blocks.pop(0)
            block = self.at(start, length)
            pos = 0
            while pos + 8 <= length and len(out) < count:
                kind, size = self.uint(block, pos, 2), self.uint(block, pos + 2, 2)
                flags = block[pos + 4]
                data = block[pos + 8:pos + 8 + size]
                if len(data) != size:
                    raise self.fail(f"message {kind:#x} at {start + pos} overruns its block")
                if kind == MSG_CONTINUATION:
                    blocks.append((self.base + self.uint(data, 0, self.so),
                                   self.uint(data, self.so, self.sl)))
                out.append((kind, flags, data))
                pos += 8 + size
        return out

    # -- groups -------------------------------------------------------------

    def _group(self, btree: int, heap: int) -> Dict[str, int]:
        """name -> object header address of a symbol-table group's members."""
        hb = self.at(self.base + heap, 8 + 2 * self.sl + self.so)
        if hb[:4] != b"HEAP":
            raise self.fail(f"no local heap at {heap}")
        names = self.at(self.base + self.uint(hb, 8 + 2 * self.sl, self.so),
                        self.uint(hb, 8, self.sl))
        members: Dict[str, int] = {}
        self._btree_node(self.base + btree, names, members)
        return members

    def _btree_node(self, addr: int, names: bytes, members: Dict[str, int]) -> None:
        head = self.at(addr, 8 + 2 * self.so)
        if head[:4] != b"TREE" or head[4] != 0:
            raise self.fail(f"no group B-tree node at {addr}")
        level, used = head[5], self.uint(head, 6, 2)
        body = self.at(addr + 8 + 2 * self.so, used * (self.sl + self.so) + self.sl)
        for i in range(used):
            child = self.base + self.uint(body, i * (self.sl + self.so) + self.sl, self.so)
            if level > 0:
                self._btree_node(child, names, members)
            else:
                self._symbol_node(child, names, members)

    def _symbol_node(self, addr: int, names: bytes, members: Dict[str, int]) -> None:
        head = self.at(addr, 8)
        if head[:4] != b"SNOD":
            raise self.fail(f"no symbol-table node at {addr}")
        entry = 2 * self.so + 24
        body = self.at(addr + 8, self.uint(head, 6, 2) * entry)
        for pos in range(0, len(body), entry):
            off = self.uint(body, pos, self.so)
            name = names[off:names.index(b"\0", off)].decode()
            members[name] = self.base + self.uint(body, pos + self.so, self.so)

    # -- datasets -----------------------------------------------------------

    def _dataset(self, name: str, addr: int) -> ContiguousArray:
        msgs = self._messages(addr)
        by_kind = {}
        for kind, flags, data in msgs:
            if kind == MSG_FILTERS:
                raise self.fail(f"dataset {name!r} has a filter pipeline (compression such as "
                                "gzip, or shuffle); only unfiltered data is read")
            if kind == MSG_EXTERNAL:
                raise self.fail(f"dataset {name!r} keeps its data in external files")
            if kind in (MSG_DATASPACE, MSG_DATATYPE) and flags & 0x2:
                raise self.fail(f"dataset {name!r} has a shared message {kind:#x}")
            by_kind.setdefault(kind, data)
        for kind, what in ((MSG_DATASPACE, "dataspace"), (MSG_DATATYPE, "datatype"),
                           (MSG_LAYOUT, "layout")):
            if kind not in by_kind:
                raise self.fail(f"dataset {name!r} has no {what} message")
        shape = self._dataspace(by_kind[MSG_DATASPACE])
        dtype = self._datatype(by_kind[MSG_DATATYPE], f"dataset {name!r}")
        if dtype != np.dtype(np.uint8):
            raise self.fail(f"dataset {name!r} is {dtype}; only uint8 is read")
        layout = by_kind[MSG_LAYOUT]
        if layout[0] != 3:
            raise self.fail(f"dataset {name!r} has a version-{layout[0]} layout message; "
                            "only version 3 is read")
        if layout[1] != 1:
            kind = _LAYOUTS.get(layout[1], f"class {layout[1]}")
            raise self.fail(f"dataset {name!r} has a {kind} layout; only contiguous "
                            "(h5py's default) is read")
        offset = self.uint(layout, 2, self.so)
        nbytes = self.uint(layout, 2 + self.so, self.sl)
        if offset == self.undefined:
            raise self.fail(f"dataset {name!r} has no storage allocated (it was created "
                            "but never written)")
        want = int(np.prod(shape, dtype=np.int64))
        if nbytes != want:
            raise self.fail(f"dataset {name!r} stores {nbytes} bytes, its shape {shape} "
                            f"needs {want}")
        if self.base + offset + nbytes > self.size:
            raise self.fail(f"dataset {name!r} is truncated: {nbytes} bytes at "
                            f"{self.base + offset} lie past the end ({self.size} bytes)")
        return ContiguousArray(self.path, self.base + offset, shape)

    def _dataspace(self, b: bytes) -> Tuple[int, ...]:
        version, rank = b[0], b[1]
        if version == 1:
            pos = 8
        elif version == 2:
            if b[3] == 2:
                raise self.fail("a null dataspace")
            pos = 4
        else:
            raise self.fail(f"dataspace version {version}")
        return tuple(self.uint(b, pos + i * self.sl, self.sl) for i in range(rank))

    def _datatype(self, b: bytes, what: str) -> np.dtype:
        cls, bits, size = b[0] & 0x0F, b[1], self.uint(b, 4, 4)
        order = ">" if bits & 0x1 else "<"
        if cls == 0 and size in (1, 2, 4, 8):
            return np.dtype(f"{order}{'i' if bits & 0x8 else 'u'}{size}")
        if cls == 1 and size in (4, 8):
            return np.dtype(f"{order}f{size}")
        kind = _TYPE_CLASSES.get(cls, f"class {cls}")
        raise self.fail(f"{what} has a {kind} datatype of {size} bytes; only integers "
                        "and floats are read")

    def _attribute(self, b: bytes) -> Tuple[str, Any]:
        version = b[0]
        if version not in (1, 2, 3):
            raise self.fail(f"attribute message version {version}")
        if version > 1 and b[1] & 0x3:
            raise self.fail("an attribute with a shared datatype or dataspace")
        name_n, type_n, space_n = (self.uint(b, p, 2) for p in (2, 4, 6))
        pad = (lambda n: -(-n // 8) * 8) if version == 1 else (lambda n: n)
        pos = 8 if version < 3 else 9
        name = b[pos:pos + name_n].split(b"\0")[0].decode()
        pos += pad(name_n)
        dtype = self._datatype(b[pos:pos + type_n], f"attribute {name!r}")
        pos += pad(type_n)
        shape = self._dataspace(b[pos:pos + space_n])
        pos += pad(space_n)
        value = np.frombuffer(b, dtype, int(np.prod(shape, dtype=np.int64)), pos).reshape(shape)
        return name, value.item() if value.ndim == 0 else value.copy()


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

_LEAF_K, _INTERNAL_K = 4, 16  # h5py's group B-tree parameters
_DATA_ALIGN = 512


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _message(kind: int, data: bytes, flags: int = 0) -> bytes:
    data = _pad8(data)
    return struct.pack("<HHB3x", kind, len(data), flags) + data


def _object_header(messages: List[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _int_type(value) -> Tuple[bytes, bytes]:
    """(datatype message body, little-endian bytes) of an integer scalar;
    a Python int is int64, as h5py stores it."""
    arr = np.asarray(value)
    if arr.ndim != 0 or arr.dtype.kind not in "iu":
        raise ValueError(f"only scalar integer attributes are written, got {arr.dtype} "
                         f"of shape {arr.shape}")
    arr = arr.astype(arr.dtype.newbyteorder("<"))
    size, signed = arr.dtype.itemsize, 0x08 if arr.dtype.kind == "i" else 0
    return struct.pack("<BBBBIHH", 0x10, signed, 0, 0, size, 0, size * 8), arr.tobytes()


def _attribute_message(name: str, value) -> bytes:
    dtype, data = _int_type(value)
    raw = name.encode() + b"\0"
    space = struct.pack("<BBB5x", 1, 0, 0)  # version 1, scalar
    body = (struct.pack("<BBHHH", 1, 0, len(raw), len(dtype), len(space))
            + _pad8(raw) + _pad8(dtype) + _pad8(space) + data)
    return _message(MSG_ATTRIBUTE, body)


def write_file(path: str, images: np.ndarray, attrs: Mapping[str, Any] = (),
               name: str = "images") -> None:
    """Write ``images`` (uint8, any shape) as the contiguous root dataset
    ``name`` with scalar integer root attributes ``attrs``: superblock 0,
    a symbol-table root, version-1 headers, as h5py writes by default."""
    images = np.ascontiguousarray(images)
    if images.dtype != np.uint8:
        raise ValueError(f"only uint8 data is written, got {images.dtype}")
    attrs = dict(attrs)

    root_at = 96  # the superblock (v0, 8-byte offsets) takes 96 bytes
    root_msgs = [_message(MSG_SYMBOL_TABLE, b"\0" * 16)]
    root_msgs += [_attribute_message(k, v) for k, v in attrs.items()]
    root_len = len(_object_header(root_msgs))
    btree_at = root_at + root_len
    btree_len = 24 + (2 * _INTERNAL_K + 1) * 8 + 2 * _INTERNAL_K * 8
    heap_at = btree_at + btree_len
    names = b"\0" * 8 + _pad8(name.encode() + b"\0")
    heap_len = 32 + len(names)
    snod_at = heap_at + heap_len
    snod_len = 8 + 2 * _LEAF_K * 40
    dset_at = snod_at + snod_len

    shape = images.shape
    dims = struct.pack(f"<{len(shape)}Q", *shape)
    dset_msgs = [
        _message(MSG_DATASPACE, struct.pack("<BBB5x", 1, len(shape), 1) + dims + dims),
        _message(MSG_DATATYPE, struct.pack("<BBBBIHH", 0x10, 0, 0, 0, 1, 0, 8), flags=1),
        _message(MSG_FILL, bytes([2, 2, 2, 1, 0, 0, 0, 0]), flags=1),
        _message(MSG_LAYOUT, struct.pack("<BBQQ", 3, 1, 0, 0)),  # address filled below
    ]
    dset_len = len(_object_header(dset_msgs))
    data_at = -(-(dset_at + dset_len) // _DATA_ALIGN) * _DATA_ALIGN
    dset_msgs[-1] = _message(MSG_LAYOUT, struct.pack("<BBQQ", 3, 1, data_at, images.nbytes))
    root_msgs[0] = _message(MSG_SYMBOL_TABLE, struct.pack("<QQ", btree_at, heap_at))
    eof = data_at + images.nbytes

    superblock = (SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, _LEAF_K,
                                          _INTERNAL_K, 0)
                  + struct.pack("<QQQQ", 0, UNDEFINED, eof, UNDEFINED)
                  + struct.pack("<QQII", 0, root_at, 1, 0) + struct.pack("<QQ", btree_at, heap_at))
    btree = (b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, UNDEFINED, UNDEFINED)
             + struct.pack("<QQQ", 0, snod_at, 8))
    heap = b"HEAP" + struct.pack("<B3xQQQ", 0, len(names), 1, heap_at + 32) + names
    snod = b"SNOD" + struct.pack("<BxH", 1, 1) + struct.pack("<QQII16x", 8, dset_at, 0, 0)

    with open(path, "wb") as f:
        for at, block, length in ((0, superblock, root_at), (root_at, _object_header(root_msgs),
                                                            root_len),
                                  (btree_at, btree, btree_len), (heap_at, heap, heap_len),
                                  (snod_at, snod, snod_len),
                                  (dset_at, _object_header(dset_msgs), dset_len)):
            assert f.tell() == at and len(block) <= length
            f.write(block + b"\0" * (length - len(block)))
        f.write(b"\0" * (data_at - f.tell()))
        images.tofile(f)
