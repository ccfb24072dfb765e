"""
A reader of HDF5 files on numpy and the standard library alone.

The card's machine has no ``h5py``, and the event files of the HDF5
pipelines (``settings/pipeline/example.cfg`` and its variants) are HDF5. This
module reads what h5py writes with its default settings (``libver``
"earliest"), which is what the JAX package's ``to_hdf`` writes, so that the
same loader runs on every machine (``utils/hdf.py:from_hdf``):

- superblock versions 0 and 1;
- version-1 object headers, with continuation blocks;
- groups stored as symbol tables (a version-1 B-tree of type 0, a local
  heap and symbol table nodes, any number of them);
- dataspaces of versions 1 and 2, scalar or simple;
- datatypes: fixed-point and floating-point of either byte order,
  fixed-length strings, variable-length strings (through the global heap),
  enumerations (h5py's bool is an int8 enum of FALSE and TRUE) and
  compounds of those (numpy structured arrays);
- data layouts: compact, contiguous and chunked (a version-1 B-tree of
  type 1), with the deflate, shuffle and Fletcher-32 filters; storage that
  was never written (the undefined address) reads as the fill value.

Anything else raises ``NotImplementedError`` naming what it met, e.g. a
superblock of version 2 or 3 or a group of the "new style" (link messages
and fractal heaps) from ``libver="latest"``.

Values come back as h5py gives them: numpy arrays in the file's byte order,
a numpy scalar for a scalar dataspace, ``S``-typed arrays for fixed-length
strings and object arrays of ``bytes`` for variable-length ones (a scalar
string is ``bytes``).
"""

from __future__ import annotations

import mmap
import zlib

import numpy as np

__all__ = ["H5File", "read_hdf5"]

_SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
_DATASPACE, _LINK_INFO, _DATATYPE = 0x0001, 0x0002, 0x0003
_FILL, _LINK, _EXTERNAL = 0x0005, 0x0006, 0x0007
_LAYOUT, _GROUP_INFO, _FILTERS = 0x0008, 0x000A, 0x000B
_CONTINUATION, _SYMBOL_TABLE = 0x0010, 0x0011

_FILTER_DEFLATE, _FILTER_SHUFFLE, _FILTER_FLETCHER32 = 1, 2, 3


class _Dataset:
    """What a dataset's object header says: its shape (None for a scalar),
    numpy dtype, the extra facts of its datatype, its layout and filters
    and its fill value."""

    def __init__(self):
        self.shape = None
        self.dtype = None
        self.vlen_string = False
        self.layout = None
        self.filters = []
        self.fill = None


class H5File:
    """An HDF5 file opened for reading.

    Parameters
    ----------
    path : str

    :meth:`read` returns the whole file, a group (as nested dicts of numpy
    values) or a dataset by path; :meth:`keys` lists a group's members.
    """

    def __init__(self, path):
        self.path = path
        with open(path, "rb") as f:
            size = f.seek(0, 2)
            if size == 0:
                raise OSError(f"{path}: empty file, not HDF5")
            self._buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        self._gheaps = {}
        self._parse_superblock()

    # -- low-level reads ------------------------------------------------------
    def close(self):
        if self._buf is not None:
            self._buf.close()
            self._buf = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _bytes(self, addr, n):
        if addr < 0 or addr + n > len(self._buf):
            raise OSError(f"{self.path}: read of {n} bytes at {addr} past"
                          " the end of the file")
        return self._buf[addr:addr + n]

    def _uint(self, raw, offset, size):
        return int.from_bytes(raw[offset:offset + size], "little")

    def _undefined(self, addr):
        return addr == (1 << (8 * self._so)) - 1

    def _address(self, raw, offset):
        """An address field: absolute, or None where it is undefined."""
        addr = self._uint(raw, offset, self._so)
        return None if self._undefined(addr) else addr + self._base

    # -- superblock ------------------------------------------------------------
    def _parse_superblock(self):
        offset = 0
        while offset + 8 <= len(self._buf):
            if self._buf[offset:offset + 8] == _SIGNATURE:
                break
            offset = 512 if offset == 0 else 2 * offset
        else:
            raise OSError(f"{self.path}: no HDF5 signature")
        raw = self._bytes(offset, 8 + 16)
        version = raw[8]
        if version not in (0, 1):
            raise NotImplementedError(
                f"{self.path}: superblock version {version} (files written"
                " with libver='latest' or 'v108' and later); this reader"
                " takes versions 0 and 1")
        self._so, self._sl = raw[13], raw[14]
        if self._so not in (2, 4, 8) or self._sl not in (2, 4, 8):
            raise NotImplementedError(
                f"{self.path}: offsets of {self._so} and lengths of"
                f" {self._sl} bytes")
        pos = offset + 24 + (4 if version == 1 else 0)
        raw = self._bytes(pos, 4 * self._so)
        self._base = self._uint(raw, 0, self._so)
        entry = pos + 4 * self._so
        self._root = self._symbol_entry(entry)[1]

    def _symbol_entry(self, addr):
        """(link name offset, object header address) of a symbol table
        entry."""
        raw = self._bytes(addr, 2 * self._so + 24)
        return (self._uint(raw, 0, self._so),
                self._address(raw, self._so))

    # -- object headers --------------------------------------------------------
    def _messages(self, addr):
        """[(type, flags, raw data)] of the object header at `addr`."""
        head = self._bytes(addr, 16)
        if head[:4] == b"OHDR":
            raise NotImplementedError(
                f"{self.path}: a version-2 object header at {addr} (written"
                " with libver='latest' or track_order); this reader takes"
                " version 1")
        if head[0] != 1:
            raise NotImplementedError(
                f"{self.path}: object header version {head[0]} at {addr}")
        n_messages = self._uint(head, 2, 2)
        blocks = [(addr + 16, self._uint(head, 8, 4))]
        out = []
        while blocks and len(out) < n_messages:
            start, length = blocks.pop(0)
            raw = self._bytes(start, length)
            pos = 0
            while pos + 8 <= length and len(out) < n_messages:
                mtype = self._uint(raw, pos, 2)
                msize = self._uint(raw, pos + 2, 2)
                flags = raw[pos + 4]
                data = raw[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if mtype == _CONTINUATION:
                    blocks.append((self._uint(data, 0, self._so) + self._base,
                                   self._uint(data, self._so, self._sl)))
                out.append((mtype, flags, data))
        return out

    # -- groups ----------------------------------------------------------------
    def _group_members(self, addr):
        """[(name, object header address)] of the group whose object header
        is at `addr`, in the order of its B-tree (by name), or None where
        the object is not a group."""
        messages = self._messages(addr)
        types = {m[0] for m in messages}
        if _SYMBOL_TABLE not in types:
            if types & {_LINK_INFO, _LINK, _GROUP_INFO}:
                raise NotImplementedError(
                    f"{self.path}: a group of the new style (link messages,"
                    " fractal heap) at {addr}, written with"
                    " libver='latest' or track_order; this reader takes"
                    " symbol-table groups")
            return None
        data = next(m[2] for m in messages if m[0] == _SYMBOL_TABLE)
        btree = self._address(data, 0)
        heap = self._local_heap(self._address(data, self._so))
        members = []
        if btree is not None:
            self._walk_group_btree(btree, heap, members)
        return members

    def _local_heap(self, addr):
        raw = self._bytes(addr, 8 + 2 * self._sl + self._so)
        if raw[:4] != b"HEAP":
            raise OSError(f"{self.path}: no local heap at {addr}")
        size = self._uint(raw, 8, self._sl)
        data = self._address(raw, 8 + 2 * self._sl)
        return self._bytes(data, size)

    def _btree_node(self, addr, node_type):
        raw = self._bytes(addr, 8 + 2 * self._so)
        if raw[:4] != b"TREE":
            raise OSError(f"{self.path}: no B-tree node at {addr}")
        if raw[4] != node_type:
            raise OSError(f"{self.path}: B-tree node of type {raw[4]} at"
                          f" {addr}, expected {node_type}")
        return raw[5], self._uint(raw, 6, 2), addr + 8 + 2 * self._so

    def _walk_group_btree(self, addr, heap, members):
        level, entries, pos = self._btree_node(addr, 0)
        key = self._sl
        raw = self._bytes(pos, key + entries * (self._so + key))
        for k in range(entries):
            child = self._address(raw, key + k * (self._so + key))
            if level > 0:
                self._walk_group_btree(child, heap, members)
            else:
                self._read_snod(child, heap, members)

    def _read_snod(self, addr, heap, members):
        raw = self._bytes(addr, 8)
        if raw[:4] != b"SNOD":
            raise OSError(f"{self.path}: no symbol table node at {addr}")
        n = self._uint(raw, 6, 2)
        entry = 2 * self._so + 24
        for k in range(n):
            name_off, header = self._symbol_entry(addr + 8 + k * entry)
            end = heap.index(b"\x00", name_off)
            members.append((heap[name_off:end].decode("utf-8"), header))

    # -- datasets ----------------------------------------------------------------
    def _dataset(self, addr):
        ds = _Dataset()
        seen = set()
        for mtype, flags, data in self._messages(addr):
            seen.add(mtype)
            if mtype == _DATASPACE:
                ds.shape = self._dataspace(data)
            elif mtype == _DATATYPE:
                if flags & 0x02:
                    raise NotImplementedError(
                        f"{self.path}: a shared (committed) datatype at"
                        f" {addr}")
                ds.dtype, ds.vlen_string, _ = self._datatype(data, 0)
            elif mtype == _LAYOUT:
                ds.layout = self._layout(data)
            elif mtype == _FILTERS:
                ds.filters = self._filters(data)
            elif mtype == _FILL:
                ds.fill = self._fill_value(data)
            elif mtype == _EXTERNAL:
                raise NotImplementedError(
                    f"{self.path}: a dataset stored in external files at"
                    f" {addr}")
        if ds.dtype is None or ds.layout is None or _DATASPACE not in seen:
            raise OSError(f"{self.path}: object at {addr} is neither a group"
                          " nor a dataset")
        return ds

    def _dataspace(self, data):
        version, rank, flags = data[0], data[1], data[2]
        if version == 1:
            pos = 8
            if rank == 0:
                return None
        elif version == 2:
            kind = data[3]
            pos = 4
            if kind == 0:
                return None
            if kind == 2:
                raise NotImplementedError(f"{self.path}: a null dataspace")
        else:
            raise NotImplementedError(
                f"{self.path}: dataspace version {version}")
        del flags
        return tuple(self._uint(data, pos + i * self._sl, self._sl)
                     for i in range(rank))

    def _datatype(self, data, pos):
        """(numpy dtype, whether a variable-length string, bytes used) of
        the datatype description at `pos`."""
        cls, version = data[pos] & 0x0F, data[pos] >> 4
        bits = int.from_bytes(data[pos + 1:pos + 4], "little")
        size = self._uint(data, pos + 4, 4)
        body = pos + 8
        if cls == 0:  # fixed-point
            order = ">" if bits & 1 else "<"
            kind = "i" if bits & 0x08 else "u"
            return np.dtype(f"{order}{kind}{size}"), False, 8 + 4
        if cls == 1:  # floating-point
            if bits & 0x40:
                raise NotImplementedError(f"{self.path}: VAX float order")
            order = ">" if bits & 1 else "<"
            if size not in (2, 4, 8):
                raise NotImplementedError(f"{self.path}: a {size}-byte float")
            return np.dtype(f"{order}f{size}"), False, 8 + 12
        if cls == 3:  # fixed-length string
            return np.dtype(f"S{size}"), False, 8
        if cls == 8:  # enumeration
            base, _, used = self._datatype(data, body)
            n = bits & 0xFFFF
            names, p = [], body + used
            for _ in range(n):
                start = p
                end = data.index(b"\x00", p)
                names.append(data[p:end].decode("utf-8"))
                p = end + 1
                if version < 3:
                    p = start + ((p - start + 7) // 8) * 8
            values = np.frombuffer(data[p:p + n * base.itemsize], dtype=base)
            if base.itemsize == 1 and dict(zip(names, values.tolist())) == {
                    "FALSE": 0, "TRUE": 1}:
                return np.dtype(np.bool_), False, p + n * base.itemsize - pos
            return base, False, p + n * base.itemsize - pos
        if cls == 6:  # compound (a numpy structured type)
            n = bits & 0xFFFF
            names, formats, offsets, p = [], [], [], body
            for _ in range(n):
                start = p
                end = data.index(b"\x00", p)
                names.append(data[p:end].decode("utf-8"))
                p = end + 1
                if version < 3:
                    p = start + ((p - start + 7) // 8) * 8
                    offsets.append(self._uint(data, p, 4))
                    if data[p + 4] != 0:
                        raise NotImplementedError(
                            f"{self.path}: an array member of a compound")
                    p += 32
                else:
                    width = max(1, (size.bit_length() + 7) // 8)
                    offsets.append(self._uint(data, p, width))
                    p += width
                member, vlen, used = self._datatype(data, p)
                if vlen:
                    raise NotImplementedError(
                        f"{self.path}: a variable-length compound member")
                formats.append(member)
                p += used
            return np.dtype({"names": names, "formats": formats,
                             "offsets": offsets, "itemsize": size}), False, \
                p - pos
        if cls == 9:  # variable-length
            if bits & 0x0F != 1:
                raise NotImplementedError(
                    f"{self.path}: a variable-length sequence (not a"
                    " string)")
            _, _, used = self._datatype(data, body)
            return np.dtype(object), True, 8 + used
        names = {2: "time", 4: "bitfield", 5: "opaque", 7: "reference",
                 10: "array"}
        raise NotImplementedError(
            f"{self.path}: datatype class {cls} ({names.get(cls, '?')})")

    def _layout(self, data):
        version = data[0]
        if version == 3:
            cls = data[1]
            if cls == 0:
                size = self._uint(data, 2, 2)
                return {"class": "compact", "data": data[4:4 + size]}
            if cls == 1:
                return {"class": "contiguous",
                        "address": self._address(data, 2),
                        "size": self._uint(data, 2 + self._so, self._sl)}
            if cls == 2:
                ndims = data[2]
                dims = [self._uint(data, 3 + self._so + 4 * i, 4)
                        for i in range(ndims)]
                return {"class": "chunked", "address": self._address(data, 3),
                        "chunk": tuple(dims[:-1]), "element": dims[-1]}
            raise NotImplementedError(f"{self.path}: layout class {cls}")
        if version in (1, 2):
            ndims, cls = data[1], data[2]
            pos = 8
            address = None
            if cls != 0:
                address = self._address(data, pos)
                pos += self._so
            dims = [self._uint(data, pos + 4 * i, 4) for i in range(ndims)]
            pos += 4 * ndims
            if cls == 0:
                size = self._uint(data, pos, 4)
                return {"class": "compact", "data": data[pos + 4:pos + 4
                                                         + size]}
            if cls == 1:
                return {"class": "contiguous", "address": address,
                        "size": None}
            if cls == 2:
                return {"class": "chunked", "address": address,
                        "chunk": tuple(dims[:-1]),
                        "element": self._uint(data, pos, 4)}
            raise NotImplementedError(f"{self.path}: layout class {cls}")
        raise NotImplementedError(
            f"{self.path}: data layout message version {version} (written"
            " with libver='latest'); this reader takes versions 1-3")

    def _filters(self, data):
        version, n = data[0], data[1]
        pos = 8 if version == 1 else 2
        out = []
        for _ in range(n):
            fid = self._uint(data, pos, 2)
            if version == 1 or fid >= 256:
                name_len = self._uint(data, pos + 2, 2)
                pos += 4
            else:
                name_len = 0
                pos += 2
            nvals = self._uint(data, pos + 2, 2)
            pos += 4
            if version == 1:
                name_len = (name_len + 7) // 8 * 8
            pos += name_len
            vals = [self._uint(data, pos + 4 * i, 4) for i in range(nvals)]
            pos += 4 * nvals
            if version == 1 and nvals % 2:
                pos += 4
            if fid not in (_FILTER_DEFLATE, _FILTER_SHUFFLE,
                           _FILTER_FLETCHER32):
                raise NotImplementedError(
                    f"{self.path}: filter {fid}; this reader takes deflate,"
                    " shuffle and Fletcher-32")
            out.append((fid, vals))
        return out

    def _fill_value(self, data):
        version = data[0]
        if version in (1, 2):
            if version == 2 and not data[3]:
                return None
            size = self._uint(data, 4, 4)
            return data[8:8 + size] if size else None
        if version == 3:
            if not data[1] & 0x20:
                return None
            size = self._uint(data, 2, 4)
            return data[6:6 + size] if size else None
        return None

    def _unfilter(self, raw, filters, mask, element):
        for k in range(len(filters) - 1, -1, -1):
            if mask & (1 << k):
                continue
            fid, vals = filters[k]
            if fid == _FILTER_DEFLATE:
                raw = zlib.decompress(raw)
            elif fid == _FILTER_SHUFFLE:
                size = vals[0] if vals else element
                n = len(raw) // size
                body = np.frombuffer(raw, np.uint8, n * size)
                raw = body.reshape(size, n).T.tobytes() + raw[n * size:]
            else:
                raw = raw[:-4]  # the Fletcher-32 checksum
        return raw

    def _element_size(self, ds):
        return 4 + self._so + 4 if ds.vlen_string else ds.dtype.itemsize

    def _empty(self, ds, shape):
        """An array of `shape` holding the fill value (zeros by default)
        in the file's element layout."""
        raw_dtype = np.dtype(f"V{self._element_size(ds)}")
        out = np.zeros(shape, dtype=raw_dtype)
        if ds.fill is not None and len(ds.fill) == raw_dtype.itemsize:
            out[...] = np.frombuffer(ds.fill, dtype=raw_dtype)[0]
        return out

    def _read_raw(self, ds):
        """The dataset's elements as a void array of its shape."""
        shape = () if ds.shape is None else ds.shape
        elem = self._element_size(ds)
        n = int(np.prod(shape, dtype=np.int64))
        layout = ds.layout
        vtype = np.dtype(f"V{elem}")
        if layout["class"] == "compact":
            return np.frombuffer(layout["data"][:n * elem],
                                 dtype=vtype).reshape(shape)
        if layout["class"] == "contiguous":
            if layout["address"] is None:
                return self._empty(ds, shape)
            return np.frombuffer(self._bytes(layout["address"], n * elem),
                                 dtype=vtype).reshape(shape)
        out = self._empty(ds, shape)
        if layout["address"] is None or n == 0:
            return out
        chunk = layout["chunk"]
        if len(chunk) != len(shape):
            raise OSError(f"{self.path}: chunk rank {len(chunk)} for a"
                          f" dataset of rank {len(shape)}")
        for offsets, size, mask, addr in self._chunks(layout["address"],
                                                      len(chunk)):
            raw = self._unfilter(self._bytes(addr, size), ds.filters, mask,
                                 elem)
            block = np.frombuffer(raw, dtype=vtype,
                                  count=int(np.prod(chunk))).reshape(chunk)
            dst = tuple(slice(o, min(o + c, s))
                        for o, c, s in zip(offsets, chunk, shape))
            src = tuple(slice(0, d.stop - d.start) for d in dst)
            out[dst] = block[src]
        return out

    def _chunks(self, addr, rank):
        """[(offsets, stored size, filter mask, address)] of every chunk
        below the chunk B-tree node at `addr`."""
        level, entries, pos = self._btree_node(addr, 1)
        key = 8 + 8 * (rank + 1)
        raw = self._bytes(pos, (entries + 1) * key + entries * self._so)
        out = []
        for k in range(entries):
            kp = k * (key + self._so)
            size = self._uint(raw, kp, 4)
            mask = self._uint(raw, kp + 4, 4)
            offsets = tuple(self._uint(raw, kp + 8 + 8 * i, 8)
                            for i in range(rank))
            child = self._address(raw, kp + key)
            if level > 0:
                out.extend(self._chunks(child, rank))
            else:
                out.append((offsets, size, mask, child))
        return out

    def _global_heap(self, addr):
        if addr not in self._gheaps:
            head = self._bytes(addr, 8 + self._sl)
            if head[:4] != b"GCOL":
                raise OSError(f"{self.path}: no global heap at {addr}")
            size = self._uint(head, 8, self._sl)
            raw = self._bytes(addr, size)
            objects = {}
            pos = 8 + self._sl
            while pos + 8 + self._sl <= size:
                index = self._uint(raw, pos, 2)
                length = self._uint(raw, pos + 8, self._sl)
                if index == 0:
                    break
                start = pos + 8 + self._sl
                objects[index] = raw[start:start + length]
                pos = start + (length + 7) // 8 * 8
            self._gheaps[addr] = objects
        return self._gheaps[addr]

    def _read_dataset(self, addr):
        ds = self._dataset(addr)
        raw = self._read_raw(ds)
        if ds.vlen_string:
            flat = raw.reshape(-1)
            out = np.empty(flat.shape, dtype=object)
            for i, elem in enumerate(flat):
                b = bytes(elem)
                length = self._uint(b, 0, 4)
                coll = self._uint(b, 4, self._so)
                index = self._uint(b, 4 + self._so, 4)
                if length == 0 or self._undefined(coll):
                    out[i] = b""
                else:
                    out[i] = bytes(
                        self._global_heap(coll + self._base)[index][:length])
            out = out.reshape(raw.shape)
        else:
            out = np.frombuffer(raw.tobytes(), dtype=ds.dtype).reshape(
                raw.shape).copy()
        return out[()] if ds.shape is None else out

    # -- the public surface ------------------------------------------------------
    def _resolve(self, path):
        addr = self._root
        for part in str(path).split("/"):
            if not part:
                continue
            members = self._group_members(addr)
            if members is None:
                raise KeyError(f"{path!r}: {part!r} is below a dataset")
            found = dict(members)
            if part not in found:
                raise KeyError(f"no member {part!r} in {path!r} of"
                               f" {self.path}")
            addr = found[part]
        return addr

    def keys(self, path="/"):
        """The member names of the group at `path`, in the file's order."""
        members = self._group_members(self._resolve(path))
        if members is None:
            raise KeyError(f"{path!r} is a dataset, not a group")
        return [name for name, _ in members]

    def is_group(self, path):
        return self._group_members(self._resolve(path)) is not None

    def read(self, path="/", choose=None):
        """The group at `path` as nested dicts (datasets as numpy values),
        or the dataset there; `choose` keeps only the named datasets of
        that group (its subgroups are read whole)."""
        addr = self._resolve(path)
        return self._read_object(addr, choose)

    def _read_object(self, addr, choose=None):
        members = self._group_members(addr)
        if members is None:
            return self._read_dataset(addr)
        out = {}
        for name, child in members:
            sub = self._group_members(child)
            if sub is None:
                if choose is not None and name not in choose:
                    continue
                out[name] = self._read_dataset(child)
            else:
                out[name] = self._read_object(child)
        return out


def read_hdf5(path, choose=None):
    """The whole file at `path` as nested dicts of numpy values."""
    with H5File(path) as f:
        return f.read("/", choose=choose)

