"""
The events-file workflow on the port (``scripts/make_events_file.py``,
``scripts/add_flux_to_events_file.py``, ``utils/mc_sim_run_settings.py``;
``testing/events_workflow.py`` writes the per-run simulation files with the
port's HDF5 writer) against the JAX package's scripts on the same files, in
float64 on the CPU:

- with the named cut, a custom cut and a join (``numu_cc+numubar_cc``):
  every field and ``weighted_aeff`` equal bit for bit, the metadata equal,
  the fluxes within 1e-12 relative;
- ``example.cfg`` from each package's unjoined file with fluxes (prob3's
  calc grid cut to 20x20): maps and errors within 1e-9 of each map's
  largest bin. The JAX loader raises on the ``metadata`` group that its own
  ``Events.save`` writes, so its side reads the file's categories; the
  port's loader skips that group;
- the two commands through ``main(argv)``, and the run settings' counts.
"""

import os

import numpy as np
import pytest

from pisa_tpu import ureg as jax_ureg
from pisa_tpu.config.parser import parse_pipeline_config as jax_parse
from pisa_tpu.core import binning as jax_binning
from pisa_tpu.core.pipeline import Pipeline as JaxPipeline
from pisa_tpu.scripts.add_flux_to_events_file import (
    add_fluxes_to_file as jax_add_fluxes,
)
from pisa_tpu.scripts.make_events_file import (
    make_events_file as jax_make_events_file,
)
from pisa_tpu.utils.flux_weights import load_2d_table as jax_load_2d_table
from pisa_tpu.utils.hdf import from_hdf as jax_from_hdf
from pisa_tpu.utils.mc_sim_run_settings import (
    DetMCSimRunsSettings as JaxDetSettings,
)
from pisa_tpu_torch import ureg
from pisa_tpu_torch.config.parser import parse_pipeline_config
from pisa_tpu_torch.core import binning
from pisa_tpu_torch.core.pipeline import Pipeline
from pisa_tpu_torch.scripts import add_flux_to_events_file, make_events_file
from pisa_tpu_torch.testing import events_workflow as W
from pisa_tpu_torch.utils.flux_weights import load_2d_table
from pisa_tpu_torch.utils.hdf import from_hdf
from pisa_tpu_torch.utils.mc_sim_run_settings import DetMCSimRunsSettings

N_PER_FLAVINT = 200
FLUX_RTOL = 1e-12
MAP_TOL = 1e-9
CUTS = {"cut": "analysis", "join": "numu_cc+numubar_cc",
        "cust_cuts": {"fields": ["true_energy"], "pass_if": "true_energy < 60"}}
FLUX_FIELDS = tuple(f"nominal_{t}_flux"
                    for t in ("nue", "nuebar", "numu", "numubar"))


@pytest.fixture(scope="module")
def workflow(tmp_path_factory):
    """Both packages' scripts on the same source files: {variant: {package:
    (Events, path, path with fluxes)}}, variants "cut_joined" and
    "unjoined"."""
    tmp = tmp_path_factory.mktemp("events_workflow")
    sources = W.write_sources(str(tmp / "sources"), N_PER_FLAVINT, seed=3)
    out = {}
    for variant, options in (("cut_joined", CUTS), ("unjoined", {})):
        out[variant] = {
            "port": W.make_example_events_file(
                make_events_file.make_events_file,
                add_flux_to_events_file.add_fluxes_to_file, load_2d_table,
                sources, str(tmp / variant / "port"), N_PER_FLAVINT,
                **options),
            "jax": W.make_example_events_file(
                jax_make_events_file, jax_add_fluxes, jax_load_2d_table,
                sources, str(tmp / variant / "jax"), N_PER_FLAVINT,
                **options),
        }
    return out


@pytest.mark.parametrize("variant", ["cut_joined", "unjoined"])
def test_events_files_match_jax(workflow, variant):
    """The files with fluxes: the same names, categories, metadata and
    fields; every field bit for bit, the fluxes within FLUX_RTOL."""
    port, jax = workflow[variant]["port"], workflow[variant]["jax"]
    for k in (1, 2):
        assert os.path.basename(port[k]) == os.path.basename(jax[k])
    got, want = from_hdf(port[2]), jax_from_hdf(jax[2])
    assert sorted(got) == sorted(want)
    assert len(got) == 13  # 12 flavints and the metadata
    assert {k: list(v) if isinstance(v, np.ndarray) else v
            for k, v in got.pop("metadata").items()} == {
        k: list(v) if isinstance(v, np.ndarray) else v
        for k, v in want.pop("metadata").items()}
    for cat, fields in want.items():
        assert sorted(got[cat]) == sorted(fields), cat
        for name, ref in fields.items():
            value = got[cat][name]
            assert value.dtype == ref.dtype and value.shape == ref.shape
            if name in FLUX_FIELDS:
                np.testing.assert_allclose(value, ref, rtol=FLUX_RTOL, atol=0)
                assert np.all(value > 0)
            else:
                np.testing.assert_array_equal(value, ref, err_msg=cat + name)
    if variant == "cut_joined":
        # the join pools both signs' CC events under each, normalized by
        # the pooled number generated; the cuts hold
        np.testing.assert_array_equal(got["numu_cc"]["true_energy"],
                                      got["numubar_cc"]["true_energy"])
        assert got["numu_cc"]["true_energy"].size > \
            got["numu_nc"]["true_energy"].size
        for fields in got.values():
            assert np.all(fields["reco_energy"] > 2)
            assert np.all(fields["true_energy"] < 60)
    else:
        assert all(f["true_energy"].size == N_PER_FLAVINT
                   for f in got.values())
        np.testing.assert_allclose(
            got["nue_cc"]["weighted_aeff"],
            1e-5 * got["nue_cc"]["true_energy"] ** 2
            / (1 + (got["nue_cc"]["true_energy"] / 50.0) ** 2), rtol=1e-12)


def test_in_memory_events_match_jax(workflow):
    """The Events that make_events_file returns: the same flavints,
    fields and metadata."""
    got = workflow["cut_joined"]["port"][0]
    want = workflow["cut_joined"]["jax"][0]
    assert [str(f) for f in got.flavints_present] == [
        str(f) for f in want.flavints_present]
    assert got.metadata == want.metadata
    for fi in want.flavints_present:
        for name, ref in want[fi].items():
            np.testing.assert_array_equal(got[fi][name], ref)


def _example(parse, binning_mod, units, events_file):
    cfg = parse("settings/pipeline/example.cfg")
    cfg[("data", "simple_data_loader")]["events_file"] = events_file
    cfg[("osc", "prob3")]["calc_mode"] = binning_mod.MultiDimBinning([
        binning_mod.OneDimBinning("true_energy", num_bins=20, is_log=True,
                                  domain=[1, 1000] * units.GeV),
        binning_mod.OneDimBinning("true_coszen", num_bins=20, is_lin=True,
                                  domain=[-1, 1]),
    ], name="calc_grid")
    return cfg


def test_example_cfg_from_each_file_matches_jax(workflow):
    """example.cfg on each package's unjoined file with fluxes: the port's
    eager maps against the JAX compiled template's, MAP_TOL of each map's
    largest bin, errors too."""
    port_file = workflow["unjoined"]["port"][2]
    jax_file = workflow["unjoined"]["jax"][2]
    jax_events = {k: v for k, v in jax_from_hdf(jax_file).items()
                  if k != "metadata"}
    want = JaxPipeline(_example(jax_parse, jax_binning, jax_ureg,
                                jax_events)).compile().get_outputs()
    got = Pipeline(_example(parse_pipeline_config, binning, ureg, port_file),
                   device="cpu").get_outputs()
    assert sorted(m.name for m in got) == sorted(m.name for m in want)
    for m in want:
        g = got[m.name]
        scale = np.max(np.abs(m.hist))
        assert scale > 0
        np.testing.assert_allclose(g.hist, m.hist, rtol=0,
                                   atol=MAP_TOL * scale, err_msg=m.name)
        np.testing.assert_allclose(g.std_devs, m.std_devs, rtol=0,
                                   atol=MAP_TOL * np.max(m.std_devs),
                                   err_msg=m.name)


def test_jax_loader_raises_on_its_own_events_file(workflow):
    """The reference fault the port does not copy: the JAX simple_data_loader
    cannot read the file its make_events_file writes (the metadata group is
    taken for a category); the port's reads it."""
    jax_file = workflow["unjoined"]["jax"][2]
    from pisa_tpu.core.events_pi import EventsPi as JaxEventsPi
    from pisa_tpu_torch.core.events_pi import EventsPi

    with pytest.raises(ValueError, match="metadata"):
        JaxEventsPi(name="jax").load_events_file(jax_file)
    events = EventsPi(name="port")
    events.load_events_file(jax_file)
    assert sorted(events) == sorted(
        k for k in from_hdf(jax_file) if k != "metadata")


def test_commands_write_the_same_file(workflow, tmp_path):
    """make_events_file's and add_flux_to_events_file's main(argv) write
    the file that the functions wrote."""
    import json

    port = workflow["unjoined"]["port"]
    runs_json = str(tmp_path / "runs.json")
    procs_json = str(tmp_path / "procs.json")
    with open(runs_json, "w") as f:
        json.dump(W.run_settings(N_PER_FLAVINT), f)
    with open(procs_json, "w") as f:
        json.dump(W.PROC_PARAMS, f)
    sources = W.write_sources(str(tmp_path / "sources"), N_PER_FLAVINT, seed=3)
    argv = ["--det", W.DETECTOR, "--proc", W.PROC_VER, "--run-settings",
            runs_json, "--data-proc-params", procs_json, "--outdir",
            str(tmp_path / "out")]
    for run, paths in sources.items():
        argv += ["--run", run, *paths]
    make_events_file.main(argv)
    path = str(tmp_path / "out" / os.path.basename(port[1]))
    add_flux_to_events_file.main(["--input", path, "--flux-file",
                                  W.FLUX_TABLE])
    written = os.path.join(os.path.dirname(path), os.path.basename(port[2]))
    got, want = from_hdf(written), from_hdf(port[2])
    for cat in want:
        for name in want[cat]:
            np.testing.assert_array_equal(got[cat][name], want[cat][name])


def test_run_settings_match_jax():
    """The bookkeeping the workflow's weighted_aeff divides by."""
    spec = W.run_settings(N_PER_FLAVINT)
    got = DetMCSimRunsSettings(spec, detector=W.DETECTOR)
    want = JaxDetSettings(spec, detector=W.DETECTOR)
    for run in W.RUNS:
        for flav in ("nue", "numubar", "nutau_cc", "numu_nc"):
            assert got.get_num_gen(run, flav_or_flavint=flav) == \
                want.get_num_gen(run, flav_or_flavint=flav)
        assert got.get_energy_range(run) == want.get_energy_range(run)
        assert [str(f) for f in got.get_flavints(run)] == [
            str(f) for f in want.get_flavints(run)]
        assert got.get_xsec(run).ver == want.get_xsec(run).ver
    assert got.get_num_gen("14600", flav_or_flavint="numu") == \
        2 * N_PER_FLAVINT
