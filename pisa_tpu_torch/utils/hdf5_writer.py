"""
A writer of HDF5 files on numpy and the standard library alone.

The writing counterpart of ``utils/hdf5_reader.py``: the card's machine has
no ``h5py``, and the events-file workflow (``scripts/make_events_file.py``,
``scripts/add_flux_to_events_file.py``, ``core/events.py:Events.save``)
writes HDF5. It writes what the JAX package's ``to_hdf`` writes through
h5py, in the oldest layout that h5py, the HDF5 library and the port's
reader all read:

- superblock version 0 with 8-byte offsets and lengths;
- groups stored as symbol tables (a version-1 B-tree of type 0 with one
  leaf, a local heap and one symbol table node; the file's group leaf
  node K is chosen so that the largest group fits in one node);
- version-1 object headers; datasets with a version-1 dataspace (scalar or
  simple), a version-2 fill value message and a contiguous layout
  (version 3);
- datatypes: fixed-point (signed and unsigned, 1-8 bytes) and IEEE
  floating-point (2, 4 and 8 bytes) in either byte order, bools as h5py
  writes them (an int8 enumeration of FALSE and TRUE), fixed-length byte
  strings (numpy ``S``) and variable-length UTF-8 strings (numpy ``U``
  and ``O`` arrays, as ``h5py.string_dtype()`` gives them) through one
  global heap collection a dataset or attribute;
- attributes (version-1 messages) on the root group.

Anything else (complex numbers, structured or datetime arrays, names with
``/``) raises rather than writing something h5py would read differently.
"""

from __future__ import annotations

import numpy as np

__all__ = ["write_hdf5"]

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEFINED = 0xFFFFFFFFFFFFFFFF
# the local heap's "no free block" offset (H5HL_FREE_NULL)
_FREE_NULL = 1
_GROUP_INTERNAL_K = 16
_MIN_LEAF_K = 4
_SYMBOL_ENTRY = 40
_MIN_COLLECTION = 4096
_MAX_OBJECTS = 0xFFFF

# object header message types
_DATASPACE, _DATATYPE, _FILL, _LAYOUT = 0x0001, 0x0003, 0x0005, 0x0008
_ATTRIBUTE, _SYMBOL_TABLE = 0x000C, 0x0011

# IEEE layouts by size: (exponent location, exponent size, mantissa size,
# exponent bias)
_FLOATS = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}


def _pad8(raw):
    return raw + b"\x00" * (-len(raw) % 8)


def _u(n, size=8):
    return int(n).to_bytes(size, "little")


class _Value:
    """An array prepared for writing: its datatype message, its dataspace
    message, whether it holds variable-length strings, and its elements
    (bytes for numbers, a list of encoded strings for strings)."""

    def __init__(self, arr, where):
        arr = np.asarray(arr)
        self.shape = arr.shape
        self.vlen = arr.dtype.kind in ("U", "O")
        if self.vlen:
            self.strings = [_encode(v, where) for v in arr.reshape(-1)]
            self.datatype = _vlen_string_type()
            self.raw = None
        else:
            self.datatype, arr = _numeric_type(arr, where)
            self.raw = arr.tobytes()
        self.dataspace = _dataspace(self.shape)


def _encode(value, where):
    if isinstance(value, bytes):
        return value
    if isinstance(value, str):
        return value.encode("utf-8")
    if isinstance(value, np.str_):
        return str(value).encode("utf-8")
    raise TypeError(f"{where}: a string array holds {type(value).__name__}"
                    " values; only str and bytes can be written")


def _vlen_string_type():
    # class 9 version 1: a string, null-terminated, UTF-8, of 1-byte
    # unsigned fixed-point elements
    base = bytes([0x10, 0, 0, 0]) + _u(1, 4) + _u(0, 2) + _u(8, 2)
    return bytes([0x19, 0x01, 0x01, 0x00]) + _u(16, 4) + base


def _fixed_type(size, signed, big):
    bits = (0x01 if big else 0) | (0x08 if signed else 0)
    return bytes([0x10, bits, 0, 0]) + _u(size, 4) + _u(0, 2) \
        + _u(8 * size, 2)


def _numeric_type(arr, where):
    """(datatype message, the array in the layout the type describes)."""
    dt = arr.dtype
    big = dt.byteorder == ">" or (dt.byteorder == "=" and
                                  np.little_endian is False)
    if dt.kind == "b":
        base = _fixed_type(1, True, False)
        members = _pad8(b"FALSE\x00") + _pad8(b"TRUE\x00")
        datatype = bytes([0x18, 0x02, 0x00, 0x00]) + _u(1, 4) + base \
            + members + bytes([0, 1])
        return datatype, arr.astype(np.int8)
    if dt.kind in ("i", "u"):
        return _fixed_type(dt.itemsize, dt.kind == "i", big), arr
    if dt.kind == "f" and dt.itemsize in _FLOATS:
        exp_loc, exp_size, mant_size, bias = _FLOATS[dt.itemsize]
        bits = bytes([0x20 | (0x01 if big else 0), 8 * dt.itemsize - 1, 0])
        props = _u(0, 2) + _u(8 * dt.itemsize, 2) + bytes(
            [exp_loc, exp_size, 0, mant_size]) + _u(bias, 4)
        return bytes([0x11]) + bits + _u(dt.itemsize, 4) + props, arr
    if dt.kind == "S":
        # class 3: null-padded ASCII, as h5py writes numpy's S type
        return bytes([0x13, 0x01, 0, 0]) + _u(dt.itemsize, 4), arr
    raise NotImplementedError(
        f"{where}: arrays of dtype {dt} are not written (ints, unsigned"
        " ints, floats of 2, 4 or 8 bytes, bools and strings are)")


def _dataspace(shape):
    if not shape:
        return bytes([1, 0, 0, 0]) + _u(0, 4)
    dims = b"".join(_u(d) for d in shape)
    return bytes([1, len(shape), 1, 0]) + _u(0, 4) + dims + dims


def _message(mtype, data, flags=0):
    data = _pad8(data)
    if len(data) > 0xFFFF:
        raise ValueError(f"an object header message of {len(data)} bytes")
    return _u(mtype, 2) + _u(len(data), 2) + bytes([flags, 0, 0, 0]) + data


def _check_name(name, where):
    if not name or "/" in name or name == ".":
        raise ValueError(f"{where}: {name!r} cannot name an HDF5 member")


class _File:
    """The file's bytes, appended in order: every object is written after
    the objects it points to, and the superblock last, at the front."""

    def __init__(self, leaf_k):
        self.leaf_k = leaf_k
        self.buf = bytearray(96)  # the superblock's room

    def append(self, raw):
        self.buf.extend(b"\x00" * (-len(self.buf) % 8))
        addr = len(self.buf)
        self.buf.extend(raw)
        return addr

    def object_header(self, messages):
        body = b"".join(messages)
        head = bytes([1, 0]) + _u(len(messages), 2) + _u(1, 4) \
            + _u(len(body), 4) + _u(0, 4)
        return self.append(head + body)

    def global_heap(self, strings):
        """A collection holding `strings` (objects 1..n); its address."""
        body = b"".join(_u(index, 2) + _u(0, 2) + _u(0, 4) + _u(len(s))
                        + _pad8(s)
                        for index, s in enumerate(strings, start=1))
        size = max(_MIN_COLLECTION, 16 + len(body) + 16)
        free = size - 16 - len(body)
        raw = b"GCOL" + bytes([1, 0, 0, 0]) + _u(size) + body \
            + _u(0, 2) + _u(0, 2) + _u(0, 4) + _u(free)
        return self.append(raw + b"\x00" * (size - len(raw)))

    def value_elements(self, value):
        """The raw elements of a prepared value (for strings, each a
        length, its collection's address and its index there; an object's
        index has 2 bytes, so a collection holds at most 65,535)."""
        if not value.vlen:
            return value.raw
        out = []
        for start in range(0, len(value.strings), _MAX_OBJECTS):
            chunk = value.strings[start:start + _MAX_OBJECTS]
            heap = self.global_heap(chunk)
            out.extend(_u(len(s), 4) + _u(heap) + _u(i, 4)
                       for i, s in enumerate(chunk, start=1))
        return b"".join(out)

    def dataset(self, arr, where):
        value = _Value(arr, where)
        raw = self.value_elements(value)
        address = self.append(raw) if raw else _UNDEFINED
        fill = bytes([2, 2, 0 if value.vlen else 2, 1]) + _u(0, 4)
        layout = bytes([3, 1]) + _u(address) + _u(len(raw))
        return self.object_header([
            _message(_DATASPACE, value.dataspace),
            _message(_DATATYPE, value.datatype, flags=1),
            _message(_FILL, fill, flags=1),
            _message(_LAYOUT, layout),
        ]), None

    def attribute(self, name, arr):
        value = _Value(arr, f"attribute {name!r}")
        raw = self.value_elements(value)
        name = name.encode("utf-8") + b"\x00"
        head = bytes([1, 0]) + _u(len(name), 2) + _u(len(value.datatype), 2) \
            + _u(len(value.dataspace), 2)
        return _message(_ATTRIBUTE, head + _pad8(name)
                        + _pad8(value.datatype) + _pad8(value.dataspace)
                        + raw)

    def group(self, tree, where, attrs=None):
        """Write the members of `tree` and then the group; (object header
        address, (B-tree, local heap) addresses)."""
        members = []
        for key, val in tree.items():
            name = str(key)
            path = f"{where.rstrip('/')}/{name}"
            _check_name(name, path)
            if isinstance(val, dict):
                members.append((name, self.group(val, path)))
            else:
                members.append((name, self.dataset(val, path)))
        members.sort(key=lambda m: m[0].encode("utf-8"))
        names = [m[0] for m in members]
        if len(set(names)) < len(names):
            raise ValueError(f"{where}: two members share a name ({names})")

        # local heap: the empty name at 0, the members' names, a free block
        heap_data = bytearray(8)
        offsets = []
        for name, _ in members:
            offsets.append(len(heap_data))
            heap_data.extend(_pad8(name.encode("utf-8") + b"\x00"))
        free_at = len(heap_data)
        heap_data.extend(_u(_FREE_NULL) + _u(16))
        data_addr = self.append(bytes(heap_data))
        heap = self.append(b"HEAP" + bytes([0, 0, 0, 0]) + _u(len(heap_data))
                           + _u(free_at) + _u(data_addr))

        # one symbol table node, sized for 2K entries as the library reads
        entries = b""
        for (name, (header, cache)), offset in zip(members, offsets):
            if cache is None:
                entries += _u(offset) + _u(header) + _u(0, 4) + _u(0, 4) \
                    + bytes(16)
            else:
                entries += _u(offset) + _u(header) + _u(1, 4) + _u(0, 4) \
                    + _u(cache[0]) + _u(cache[1])
        snod = b"SNOD" + bytes([1, 0]) + _u(len(members), 2) + entries
        snod += bytes(8 + 2 * self.leaf_k * _SYMBOL_ENTRY - len(snod))
        btree_raw = b"TREE" + bytes([0, 0])
        if members:
            snod_addr = self.append(snod)
            btree_raw += _u(1, 2) + _u(_UNDEFINED) + _u(_UNDEFINED) \
                + _u(0) + _u(snod_addr) + _u(offsets[-1])
        else:
            btree_raw += _u(0, 2) + _u(_UNDEFINED) + _u(_UNDEFINED) + _u(0)
        size = 24 + (2 * _GROUP_INTERNAL_K + 1) * 8 + 2 * _GROUP_INTERNAL_K * 8
        btree = self.append(btree_raw + bytes(size - len(btree_raw)))

        messages = [_message(_SYMBOL_TABLE, _u(btree) + _u(heap))]
        for name, val in (attrs or {}).items():
            messages.append(self.attribute(str(name), val))
        return self.object_header(messages), (btree, heap)

    def superblock(self, root):
        header, (btree, heap) = root
        self.buf.extend(b"\x00" * (-len(self.buf) % 8))
        sb = _SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0]) \
            + _u(self.leaf_k, 2) + _u(_GROUP_INTERNAL_K, 2) + _u(0, 4) \
            + _u(0) + _u(_UNDEFINED) + _u(len(self.buf)) + _u(_UNDEFINED) \
            + _u(0) + _u(header) + _u(1, 4) + _u(0, 4) + _u(btree) + _u(heap)
        assert len(sb) == 96
        self.buf[:96] = sb


def _largest_group(tree):
    sizes = [len(tree)]
    for val in tree.values():
        if isinstance(val, dict):
            sizes.append(_largest_group(val))
    return max(sizes)


def write_hdf5(tree, path, attrs=None):
    """Write the nested dict `tree` (dicts become groups, everything else
    a dataset through ``np.asarray``) to a new HDF5 file at `path`, with
    the root attributes `attrs` (a dict of names to arrays or scalars)."""
    leaf_k = max(_MIN_LEAF_K, (_largest_group(tree) + 1) // 2)
    if leaf_k > 0xFFFF:
        raise ValueError("a group of more than 131,070 members")
    out = _File(leaf_k)
    out.superblock(out.group(tree, "/", attrs=attrs))
    with open(path, "wb") as f:
        f.write(out.buf)
    return path

