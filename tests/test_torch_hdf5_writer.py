"""
The port's HDF5 writer (``pisa_tpu_torch/utils/hdf5_writer.py``, numpy and
the standard library only) through ``utils/hdf.py:to_hdf`` against the JAX
package's ``to_hdf`` (h5py): a dict written by the port and read by h5py
and by the JAX ``from_hdf`` equals the same dict written by the JAX
``to_hdf`` and read by the port, in values, dtypes and shapes (every bit,
NaN and infinity included): nested and empty groups, a group of 40 members,
ints and unsigned ints of every width, floats of 2, 4 and 8 bytes in either
byte order, bools, variable-length UTF-8 strings (empty ones, non-ASCII
ones, more than one global heap collection's 65,535), fixed-length byte
strings, scalars, empty arrays and root attributes; ``Events.save`` and a
write with ``h5py`` unimportable.
"""

import ast
import sys

import h5py
import numpy as np
import pytest

from pisa_tpu.core.events import Events as JaxEvents
from pisa_tpu.utils.hdf import from_hdf as jax_from_hdf
from pisa_tpu.utils.hdf import to_hdf as jax_to_hdf
from pisa_tpu_torch.core.events import Events
from pisa_tpu_torch.utils import hdf, hdf5_writer
from pisa_tpu_torch.utils.hdf import from_hdf, to_hdf


def _tree():
    """Seeded values of every kind the JAX ``to_hdf`` writes."""
    rng = np.random.RandomState(5)
    floats = rng.normal(size=9)
    floats[[1, 4]] = [np.nan, -np.inf]
    return {
        "f8": floats,
        "f4": floats.astype(np.float32),
        "f2": floats[:5].astype(np.float16),
        "f8_big": floats.astype(">f8"),
        "f4_big": floats.astype(">f4"),
        "ints": {f"{k}{w}": rng.randint(-100 if k == "i" else 0, 100,
                                        size=6).astype(f"{k}{w}")
                 for k in "iu" for w in (1, 2, 4, 8)},
        "i4_big": np.arange(-3, 3, dtype=">i4"),
        "bools": rng.uniform(size=7) > 0.5,
        "matrix": rng.normal(size=(3, 4, 2)),
        "strings": np.array(["numu_cc", "", "νμ → ντ", "x" * 300]),
        "objects": np.array(["a", "bc", ""], dtype=object),
        "bytes": np.array([b"ab", b"c"]),
        "scalars": {"f": 2.5, "i": np.int32(-7), "b": True, "s": "detector",
                    "u": np.uint16(9)},
        "empty": {"f": np.array([]), "s": np.array([], dtype="U1"),
                  "i": np.zeros((0, 3), dtype=np.int64)},
        "empty_group": {},
        "wide": {f"field_{k:02d}": np.full(k, k, dtype=np.float32)
                 for k in range(40)},
        "deep": {"a": {"b": {"c": np.arange(3)}}},
    }


ATTRS = {"livetime": 3.5, "name": "toy", "runs": np.arange(3),
         "flags": np.array([True, False])}


def assert_bits_equal(got, want, path=""):
    """Equal nested dicts: the same keys, values of the same type, dtype
    and shape, every bit of every element equal (strings by value)."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_bits_equal(got[k], want[k], f"{path}/{k}")
        return
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.shape == want.shape, (
            path, got.dtype, want.dtype, got.shape, want.shape)
        if want.dtype == object:
            assert got.tolist() == want.tolist(), path
        else:
            assert got.tobytes() == want.tobytes(), path
    else:
        assert got == want, (path, got, want)


def _h5py_read(path):
    """(nested dict of ``dset[()]``, root attributes) as h5py reads them."""
    def group(g):
        return {k: group(v) if isinstance(v, h5py.Group) else v[()]
                for k, v in g.items()}
    with h5py.File(path, "r") as f:
        return group(f), dict(f.attrs)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The tree written by each package's to_hdf."""
    tmp = tmp_path_factory.mktemp("writer")
    port, jax = str(tmp / "port.hdf5"), str(tmp / "jax.hdf5")
    to_hdf(_tree(), port, attrs=ATTRS)
    jax_to_hdf(_tree(), jax, attrs=ATTRS)
    return port, jax


def test_h5py_reads_the_port_file_as_the_jax_file(files):
    """h5py's values and attributes of the port's file equal those of the
    JAX package's file."""
    port, jax = files
    got, got_attrs = _h5py_read(port)
    want, want_attrs = _h5py_read(jax)
    assert_bits_equal(got, want)
    assert sorted(got_attrs) == sorted(want_attrs)
    for k in want_attrs:
        assert_bits_equal(got_attrs[k], want_attrs[k], k)


def test_each_from_hdf_reads_either_file_the_same(files):
    """The JAX from_hdf of the port's file, the port's from_hdf of the JAX
    file and of its own: one nested dict, bit for bit."""
    port, jax = files
    want = jax_from_hdf(jax)
    assert_bits_equal(jax_from_hdf(port), want)
    assert_bits_equal(from_hdf(jax), want)
    assert_bits_equal(from_hdf(port), want)


def test_values_survive_the_round_trip(files):
    """What the port wrote is what it was given (strings come back as
    UTF-8 bytes, as h5py gives them)."""
    back = from_hdf(files[0])
    tree = _tree()
    for key in ("f8", "f4", "f2", "f8_big", "matrix", "bools"):
        assert back[key].dtype == tree[key].dtype
        assert back[key].tobytes() == tree[key].tobytes(), key
    assert back["strings"].tolist() == [s.encode() for s in tree["strings"]]
    assert back["scalars"]["s"] == "detector"  # from_hdf decodes a scalar
    assert back["scalars"]["b"] is np.True_
    assert back["empty"]["i"].shape == (0, 3)
    assert back["empty_group"] == {}
    assert back["deep"]["a"]["b"]["c"].tolist() == [0, 1, 2]


def _imported(path):
    """The top-level names of every module that the file imports."""
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_writes_without_h5py(tmp_path, monkeypatch):
    """With h5py unimportable the port writes (and reads) the file, and
    h5py reads it afterwards as the JAX package's."""
    for module in (hdf5_writer, hdf):
        assert "h5py" not in _imported(module.__file__), module.__name__
    path = str(tmp_path / "no_h5py.hdf5")
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "h5py", None)
        with pytest.raises(ImportError):
            import h5py as _  # noqa: F401
        to_hdf(_tree(), path, attrs=ATTRS)
        back = from_hdf(path)
    want = str(tmp_path / "jax.hdf5")
    jax_to_hdf(_tree(), want, attrs=ATTRS)
    assert_bits_equal(back, from_hdf(want))
    assert_bits_equal(_h5py_read(path)[0], _h5py_read(want)[0])


def test_many_strings_take_several_collections(tmp_path):
    """More strings than one global heap collection indexes (65,535)."""
    strings = np.array([f"s{k}" for k in range(70_000)])
    path = str(tmp_path / "strings.hdf5")
    to_hdf({"s": strings}, path)
    with h5py.File(path, "r") as f:
        got = f["s"][()]
    assert got.tolist() == [s.encode() for s in strings]
    assert from_hdf(path)["s"].tolist() == got.tolist()


def _events(package):
    """An Events of two flavints and the make_events_file metadata, seeded;
    either package's class."""
    cls = Events if package == "port" else JaxEvents
    rng = np.random.RandomState(9)
    evts = cls()
    for fi in ("numu_cc", "nue_nc"):
        evts[fi] = {"true_energy": rng.uniform(1, 80, 25),
                    "weighted_aeff": rng.uniform(0, 1e-4, 25),
                    "pid": rng.uniform(-3, 3, 25)}
    evts.metadata.update({"detector": "toydet", "proc_ver": "5",
                          "runs": ["12600", "14600"],
                          "cuts": ["analysis"]})
    return evts


def test_events_save_matches_jax(tmp_path):
    """Events.save (strings, empty lists, per-flavint fields) read back by
    both packages' Events equals the JAX package's save."""
    port, jax = str(tmp_path / "port.hdf5"), str(tmp_path / "jax.hdf5")
    _events("port").save(port)
    _events("jax").save(jax)
    assert_bits_equal(from_hdf(port), jax_from_hdf(jax))
    for cls in (Events, JaxEvents):
        got, want = cls(port), cls(jax)
        assert sorted(map(str, got.flavints_present)) == ["nue_nc", "numu_cc"]
        for fi in got.flavints_present:
            assert_bits_equal(dict(got[fi]), dict(want[fi]), str(fi))
        assert sorted(got.metadata) == sorted(want.metadata)
        assert got.metadata["detector"] == "toydet"


@pytest.mark.parametrize("value, error", [
    (np.array([1 + 2j]), NotImplementedError),
    (np.array([None], dtype=object), TypeError),
])
def test_refuses_what_it_cannot_write(tmp_path, value, error):
    with pytest.raises(error):
        to_hdf({"x": value}, str(tmp_path / "bad.hdf5"))


def test_refuses_names_h5py_would_split(tmp_path):
    with pytest.raises(ValueError, match="cannot name"):
        to_hdf({"a/b": np.arange(2)}, str(tmp_path / "bad.hdf5"))
    with pytest.raises(IOError):
        path = str(tmp_path / "kept.hdf5")
        to_hdf({"a": 1}, path)
        to_hdf({"a": 2}, path, overwrite=False)


def test_h5py_extends_a_port_file(tmp_path):
    """The HDF5 library takes the port's file as its own: h5py adds
    datasets past a symbol-table node's room, an attribute, deletes a
    member, and both readers read the result."""
    path = str(tmp_path / "extended.hdf5")
    to_hdf({"g": {f"k{i:02d}": np.arange(i) for i in range(13)},
            "s": np.array(["a", "bc"])}, path, attrs={"a": 1})
    with h5py.File(path, "r+") as f:
        f["g"].create_dataset("new", data=np.arange(5.0))
        for i in range(30):
            f.create_dataset(f"more{i:02d}", data=np.full(i, i))
        f.attrs["b"] = "text"
        del f["g/k03"]
    back = from_hdf(path)
    assert_bits_equal(back, jax_from_hdf(path))
    assert sorted(back["g"]) == sorted(
        [f"k{i:02d}" for i in range(13) if i != 3] + ["new"])
    assert back["more29"].tolist() == [29] * 29
    assert back["s"].tolist() == [b"a", b"bc"]
    with h5py.File(path, "r") as f:
        assert dict(f.attrs) == {"a": 1, "b": "text"}
