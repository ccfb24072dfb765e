"""
The port's HDF5 reader (``pisa_tpu_torch/utils/hdf5_reader.py``, numpy and
the standard library only) and what reads through it (``utils/hdf.py``,
``utils/fileio.py``, ``utils/hdfchain.py``, ``utils/data_proc_params.py``)
against the JAX package's h5py-based versions and against h5py itself, on
files that h5py writes here: nested groups, a group of 40 datasets (several
symbol-table nodes), every supported datatype and layout, a ragged last
chunk, deflate + shuffle + Fletcher-32, storage never written, and the
repo's events file. Values must be equal (dtype, shape and every element).
"""

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest

from pisa_tpu.utils.data_proc_params import DataProcParams as JaxDPP
from pisa_tpu.utils.hdf import from_hdf as jax_from_hdf
from pisa_tpu.utils.hdfchain import HDFChain as JaxChain
from pisa_tpu_torch.utils import fileio
from pisa_tpu_torch.utils.data_proc_params import DataProcParams
from pisa_tpu_torch.utils.hdf import from_hdf, to_hdf
from pisa_tpu_torch.utils.hdf5_reader import H5File, read_hdf5
from pisa_tpu_torch.utils.hdfchain import HDFChain
from pisa_tpu_torch.utils.resources import find_resource

EVENTS = ("events/events__vlvnt__toy_1_to_80GeV_spidx1.0_cz-1_to_1_1e2evts"
          "_set0__unjoined__with_fluxes_honda-2015-spl-solmin-aa.hdf5")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_same(got, want, path=""):
    """Equal nested dicts: the same keys in the same order, values of the
    same type, dtype, shape and elements."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert list(got) == list(want), (path, list(got), list(want))
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}")
        return
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, (
            path, got.dtype, want.dtype, got.shape, want.shape)
        assert got.ravel().tolist() == want.ravel().tolist(), path
    else:
        assert got == want, (path, got, want)


@pytest.fixture(scope="module")
def h5_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("h5") / "kinds.h5")
    rng = np.random.RandomState(0)
    compound = np.zeros(7, dtype=[("energy", "f8"), ("coszen", "<f4"),
                                  ("flag", "?"), ("n", ">i2")])
    compound["energy"] = rng.uniform(size=7)
    compound["flag"][::2] = True
    compound["n"] = -np.arange(7)
    with h5py.File(path, "w") as f:
        many = f.create_group("many")
        for i in range(40):
            many.create_dataset(f"d{i:02d}", data=rng.normal(size=5))
        f.create_group("a/b/c").create_dataset("x", data=np.arange(7,
                                                                 dtype="i4"))
        f.create_dataset("i8", data=np.arange(-5, 5, dtype=np.int8))
        f.create_dataset("u16be", data=np.arange(10, dtype=">u2"))
        f.create_dataset("u64", data=np.arange(5, dtype=np.uint64) * 2**40)
        f.create_dataset("f16", data=np.arange(5, dtype=np.float16))
        f.create_dataset("f32be", data=rng.normal(size=(3, 4)).astype(">f4"))
        f.create_dataset("bool", data=rng.uniform(size=9) > 0.5)
        f.create_dataset("fixed_str", data=np.array([b"ab", b"cde", b""],
                                                    dtype="S3"))
        f.create_dataset("vlen_str", data=np.array(
            ["alpha", "be", "", "gamma" * 20], dtype=object),
            dtype=h5py.string_dtype())
        f.create_dataset("vlen_scalar", data="hello",
                         dtype=h5py.string_dtype())
        f.create_dataset("fixed_scalar", data=np.bytes_(b"xyz"))
        f.create_dataset("scalar", data=3.5)
        f.create_dataset("int_scalar", data=np.int64(-4))
        f.create_dataset("compound", data=compound)
        f.create_dataset("compound_chunked", data=compound, chunks=(3,),
                         compression="gzip")
        f.create_dataset("chunked_ragged", data=rng.normal(size=(23, 7)),
                         chunks=(5, 3))
        f.create_dataset("deflate_shuffle", data=rng.normal(size=1000),
                         chunks=(64,), compression="gzip", shuffle=True)
        f.create_dataset("fletcher", data=np.arange(300, dtype=np.int16),
                         chunks=(100,), fletcher32=True, compression="gzip")
        f.create_dataset("unwritten", shape=(6,), dtype="f8")
        f.create_dataset("unwritten_fill", shape=(6,), dtype="f8",
                         fillvalue=2.5)
        f.create_dataset("chunks_unwritten", shape=(10,), dtype="i4",
                         chunks=(4,), fillvalue=7)
        part = f.create_dataset("chunks_partial", shape=(10,), dtype="i4",
                                chunks=(4,), fillvalue=-1)
        part[0:3] = [1, 2, 3]
        f.create_dataset("empty", data=np.zeros((0, 3)))
        f.attrs["note"] = "attributes are not returned"
    return path


def test_reader_equals_jax_from_hdf(h5_file):
    assert_same(from_hdf(h5_file), jax_from_hdf(h5_file))


def test_reader_equals_h5py_values(h5_file):
    """Every dataset as h5py's ``dset[()]`` gives it (bytes undecoded)."""
    got = read_hdf5(h5_file)
    with h5py.File(h5_file, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                node = got
                for part in name.split("/"):
                    node = node[part]
                assert_same(node, obj[()], name)

        f.visititems(visit)
    assert len(got["many"]) == 40


def test_events_file_equals_jax():
    path = find_resource(EVENTS)
    assert_same(from_hdf(path), jax_from_hdf(path))
    assert_same(fileio.from_file(EVENTS), jax_from_hdf(path))


def test_choose_keeps_top_level_datasets(h5_file):
    got = from_hdf(h5_file, choose=["scalar", "bool"])
    assert_same(got, jax_from_hdf(h5_file, choose=["scalar", "bool"]))
    assert "many" in got and "i8" not in got


def test_group_access(h5_file):
    with H5File(h5_file) as f:
        assert f.keys("/many")[:3] == ["d00", "d01", "d02"]
        assert f.is_group("/a/b") and not f.is_group("/a/b/c/x")
        np.testing.assert_array_equal(f.read("a/b/c/x"), np.arange(7))
        with pytest.raises(KeyError):
            f.read("/nope")


@pytest.mark.parametrize("kind", ["libver_latest", "track_order"])
def test_refuses_what_it_does_not_read(tmp_path, kind):
    path = str(tmp_path / f"{kind}.h5")
    kwargs = {"libver": "latest"} if kind == "libver_latest" else {
        "track_order": True}
    with h5py.File(path, "w", **kwargs) as f:
        f.create_dataset("x", data=[1, 2])
    with pytest.raises(NotImplementedError):
        from_hdf(path)


def test_reads_events_without_h5py():
    """A process in which h5py cannot import reads the events file through
    the port, and the loader's stage sets up from it."""
    code = (
        "import sys; sys.modules['h5py'] = None\n"
        "from pisa_tpu_torch.utils.hdf import from_hdf\n"
        "from pisa_tpu_torch.utils.resources import find_resource\n"
        f"d = from_hdf(find_resource({EVENTS!r}))\n"
        "assert sorted(d) == ['nue', 'nue_bar', 'numu', 'numu_bar', 'nutau',"
        " 'nutau_bar'], sorted(d)\n"
        "assert d['numu']['cc']['true_energy'].shape == (100,)\n"
        "from pisa_tpu_torch.stages.data.simple_data_loader import init_test\n"
        "s = init_test()\n"
        "assert len(s.evts) == 12\n"
        "assert 'h5py' not in [m for m in sys.modules if sys.modules[m]]\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_to_hdf_round_trip_and_missing_h5py(tmp_path, monkeypatch):
    d = {"g": {"x": np.arange(4.0), "s": np.array(["a", "bc"])},
         "y": np.int32(3)}
    path = str(tmp_path / "out.hdf5")
    fileio.to_file(d, path)
    got = from_hdf(path)
    assert_same(got, jax_from_hdf(path))
    np.testing.assert_array_equal(got["g"]["x"], d["g"]["x"])
    # the port writes without h5py (utils/hdf5_writer.py): a file written
    # with h5py unimportable reads back the same
    monkeypatch.setitem(sys.modules, "h5py", None)
    other = str(tmp_path / "other.h5")
    to_hdf(d, other)
    assert_same(from_hdf(other), got)


@pytest.fixture
def chain_files(tmp_path):
    dt = np.dtype([("energy", "f8"), ("coszen", "f8")])
    names = []
    for i in range(3):
        fname = str(tmp_path / f"part{i}.h5")
        with h5py.File(fname, "w") as f:
            arr = np.zeros(10 * (i + 1), dtype=dt)
            arr["energy"] = np.arange(10 * (i + 1)) + 100 * i
            f.create_dataset("events", data=arr)
            f.create_group("deep").create_dataset("nested", data=np.arange(
                4.0))
        names.append(fname)
    return names


@pytest.mark.parametrize("maxdepth", [1, 2])
def test_hdfchain_equals_jax(chain_files, tmp_path, maxdepth):
    chain = HDFChain(str(tmp_path / "part*.h5"), maxdepth=maxdepth)
    want = JaxChain(chain_files, maxdepth=maxdepth)
    assert sorted(chain.pathes) == sorted(want.pathes)
    for path, proxy in want.pathes.items():
        got = chain.getNode(path)
        assert len(got) == len(proxy)
        assert_same(got.read(), proxy.read(), path)
    np.testing.assert_array_equal(chain.root.events.col("energy"),
                                  want.root.events.col("energy"))
    chain.close()
    want.close()
    with pytest.raises(ValueError):
        HDFChain([])


def test_data_proc_params_get_data_equals_jax(tmp_path):
    """``DataProcParams.get_data`` from a file path (the JAX package's
    through h5py, the port's through its reader), with an expression
    field, a code translation and the derived coszen fields."""
    rng = np.random.RandomState(2)
    path = str(tmp_path / "proc.h5")
    with h5py.File(path, "w") as f:
        g = f.create_group("I3MCTree")
        g.create_dataset("energy", data=rng.uniform(1, 50, 30))
        g.create_dataset("zenith", data=rng.uniform(0, np.pi, 30))
        f.create_dataset("code", data=rng.choice([1, 2, 3], 30))
        f.create_dataset("itype", data=rng.choice([1, 2], 30))
    spec = {"DeepCore": {"5": {
        "field_map": {
            "true_energy": "I3MCTree/energy",
            "true_zenith": "I3MCTree/zenith",
            "log_e": "np.log10(I3MCTree/energy)",
            "nu_code": "code",
            "interaction_type": "itype",
        },
        "nu_code_to_pdg_map": {"1": 12, "2": 14, "3": 16},
        "cuts": {"bright": {"fields": ["true_energy"],
                            "pass_if": "true_energy > 10"}},
    }}}
    got = DataProcParams("deepcore", "v5", spec).get_data(path)
    want = JaxDPP("deepcore", "v5", spec).get_data(path)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    dpp = DataProcParams("deepcore", "v5", spec)
    cut = dpp.apply_cuts(got, ["bright", "cc"])
    cut_jax = JaxDPP("deepcore", "v5", spec).apply_cuts(want, ["bright", "cc"])
    for k in cut_jax:
        np.testing.assert_array_equal(cut[k], cut_jax[k], err_msg=k)
