"""
The port's command-line entry points (``pisa_tpu_torch/scripts/``) against
the JAX package's, in fp64 on the CPU (conftest), each called through its
``main(argv)`` with ``--device cpu``:

- ``pipeline`` and ``distribution_maker``: the written JSON against the
  JAX commands' on the toy configs, to 1e-9 relative per bin (the same
  arithmetic in another order);
- ``detectors`` on the two detector configs of tests/test_detectors.py;
- ``compare`` on the cases of tests/test_compare_script.py, through the
  port's ``Map``, and its summary against the JAX function's;
- ``analysis`` on ``toy_flux_fit.cfg`` (two_nu_osc, cheap on the CPU)
  against data moved off the nominal: the same best fit as the JAX
  command, to 1e-6 rescaled;
- ``benchmark``: each route prints a line that parses;
- ``convert_config``: the text equal to JAX's on every packaged config,
  and its gated services those the JAX package has and the port lacks;
- ``run_unit_tests``: its suites' files exist;
- ``test_services``: its markdown and exit code over the whole matrix;
- ``pyproject.toml``: every ``pisa-tpu-torch-*`` command names a module
  of the port with a ``main``.
"""

import glob
import importlib
import json
import os
import re
import tomllib

import numpy as np
import pytest

from pisa_tpu.core.distribution_maker import (
    DistributionMaker as JaxDistributionMaker,
)
from pisa_tpu.core.map import MapSet as JaxMapSet
from pisa_tpu.scripts import analysis as jax_analysis
from pisa_tpu.scripts import compare as jax_compare
from pisa_tpu.scripts import convert_config as jax_convert_config
from pisa_tpu.scripts import detectors as jax_detectors
from pisa_tpu.scripts import distribution_maker as jax_distribution_maker
from pisa_tpu.scripts import pipeline as jax_pipeline
from pisa_tpu.testing.service_matrix import (
    discover_services as jax_discover_services,
)
from pisa_tpu.utils.resources import find_resource
from pisa_tpu_torch import ureg
from pisa_tpu_torch.core.binning import MultiDimBinning, OneDimBinning
from pisa_tpu_torch.core.map import Map, MapSet
from pisa_tpu_torch.core.param import ParamSet
from pisa_tpu_torch.scripts import analysis, benchmark, compare
from pisa_tpu_torch.scripts import convert_config, detectors
from pisa_tpu_torch.scripts import distribution_maker, pipeline
from pisa_tpu_torch.scripts import run_unit_tests, test_services
from pisa_tpu_torch.testing.service_matrix import (
    discover_services,
    run_service,
)
from pisa_tpu_torch.utils.fileio import from_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = "settings/pipeline/toy_fit_example.cfg"
FLUX = "settings/pipeline/toy_flux_fit.cfg"
MAP_RTOL = 1e-9
FIT_X_ATOL = 1e-6  # rescaled
CPU = ["--device", "cpu"]


def maps_of(path, mapset_cls):
    """{name: hist} of a written MapSet JSON, read by `mapset_cls`."""
    return {m.name: np.asarray(m.hist, dtype=np.float64)
            for m in mapset_cls.from_json(path)}


def assert_maps_close(port_path, jax_path):
    got, want = maps_of(port_path, MapSet), maps_of(jax_path, JaxMapSet)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=MAP_RTOL,
                                   atol=0, err_msg=name)
    assert sum(h.sum() for h in want.values()) > 0


# -- pipeline, distribution_maker, detectors -----------------------------------------
@pytest.fixture(scope="module")
def jax_toy_outputs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_pipeline"))
    assert jax_pipeline.main([TOY, "--outdir", out]) == 0
    return os.path.join(out, "neutrinos__outputs.json.bz2")


@pytest.mark.parametrize("extra", [[], ["--compile"], ["--profile"]],
                         ids=["eager", "compiled", "profiled"])
def test_pipeline_outputs_match_jax(jax_toy_outputs, tmp_path, capsys, extra):
    assert pipeline.main([TOY, "--outdir", str(tmp_path), *extra, *CPU]) == 0
    out = capsys.readouterr().out
    path = str(tmp_path / "neutrinos__outputs.json.bz2")
    assert f"wrote {path}" in out
    assert_maps_close(path, jax_toy_outputs)
    if "--profile" in extra:
        assert "Pipeline: neutrinos" in out


def test_pipeline_stops_after_a_stage(capsys):
    assert pipeline.main([TOY, "--stop-after-stage", "osc.prob3", *CPU]) == 0
    out = capsys.readouterr().out
    assert "ran stages 0..2; container keys:" in out
    assert re.search(r"^  numu_cc: \[.*'weights'", out, re.M)


@pytest.mark.parametrize("pipelines,extra", [
    ([TOY, FLUX], []),
    ([TOY, TOY], ["--return-sum"]),
], ids=["two", "summed"])
def test_distribution_maker_outputs_match_jax(tmp_path, pipelines, extra):
    args = [a for p in pipelines for a in ("-p", p)] + extra
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    assert jax_distribution_maker.main(
        args + ["--outdir", str(jax_out)]) == 0
    assert distribution_maker.main(
        args + ["--outdir", str(port_out), *CPU]) == 0
    names = sorted(os.listdir(jax_out))
    assert names == sorted(os.listdir(port_out))
    assert len(names) == (1 if extra else 2)
    for name in names:
        assert_maps_close(str(port_out / name), str(jax_out / name))


def _make_det_config(tmp_path, det_name, nutau_norm_value):
    """tests/test_detectors.py:_make_det_config."""
    text = open(find_resource(TOY)).read()
    text = text.replace("name = neutrinos",
                        f"name = neutrinos\ndetector_name = {det_name}")
    text = text.replace("param.nutau_cc_norm = 0.5",
                        f"param.nutau_cc_norm = {nutau_norm_value}")
    path = tmp_path / f"{det_name}.cfg"
    path.write_text(text)
    return str(path)


def test_detectors_outputs_match_jax(tmp_path, capsys):
    args = ["-p", _make_det_config(tmp_path, "detA", 0.5),
            "-p", _make_det_config(tmp_path, "detB", 0.8),
            "--shared-params", "theta23,deltam31,theta13"]
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    assert jax_detectors.main(args + ["--outdir", str(jax_out)]) == 0
    capsys.readouterr()
    assert detectors.main(args + ["--outdir", str(port_out), *CPU]) == 0
    assert "[detB] neutrinos: total" in capsys.readouterr().out
    for det in ("detA", "detB"):
        name = f"{det}__outputs.json.bz2"
        assert_maps_close(str(port_out / name), str(jax_out / name))
    # each detector's summed map; detB's larger nutau_cc_norm shows
    a = maps_of(str(port_out / "detA__outputs.json.bz2"), MapSet)
    b = maps_of(str(port_out / "detB__outputs.json.bz2"), MapSet)
    assert list(a) == list(b) == ["neutrinos"]
    assert b["neutrinos"].sum() > a["neutrinos"].sum()


# -- compare -----------------------------------------------------------------------
@pytest.fixture
def binning():
    e = OneDimBinning("reco_energy", num_bins=6, is_log=True,
                      domain=[5, 50] * ureg.GeV)
    cz = OneDimBinning("reco_coszen", num_bins=5, is_lin=True, domain=[-1, 1])
    return MultiDimBinning([e, cz], name="b")


@pytest.fixture
def mapset_pair(binning):
    rng = np.random.RandomState(7)
    ref_maps, test_maps = [], []
    for n in ("numu_cc", "numubar_cc", "nue_cc"):
        h = rng.uniform(1, 10, binning.shape)
        ref_maps.append(Map(name=n, hist=h, binning=binning))
        test_maps.append(Map(name=n, hist=h * 1.01, binning=binning))
    return MapSet(ref_maps, name="ref"), MapSet(test_maps, name="test")


@pytest.fixture
def written_pair(mapset_pair, tmp_path):
    paths = []
    for label, ms in zip(("ref", "test"), mapset_pair):
        paths.append(str(tmp_path / f"{label}.json.bz2"))
        ms.to_json(paths[-1])
    return paths


def test_compare_distributions(mapset_pair, written_pair):
    ref, test = mapset_pair
    summary, diff, fdiff, asymm, ok = compare.compare_distributions(
        ref, test, rtol=1e-8)
    assert not ok  # 1% off at rtol=1e-8
    assert set(summary) == {"numu_cc", "numubar_cc", "nue_cc"}
    assert np.isclose(summary["numu_cc"]["max_abs_fract_diff"], 0.01)
    r = np.asarray(ref["numu_cc"].hist)
    assert np.allclose(np.asarray(diff["numu_cc"].hist), 0.01 * r)
    assert np.allclose(np.asarray(asymm["numu_cc"].hist), 0.01 * np.sqrt(r))
    assert np.allclose(np.asarray(fdiff["numu_cc"].hist), 0.01)
    assert compare.compare_distributions(ref, test, rtol=0.02)[4]
    # the JAX function's summary on the same maps
    jax_summary = jax_compare.compare_distributions(
        *(JaxMapSet.from_json(p) for p in written_pair), rtol=1e-8)[0]
    assert summary == jax_summary


def test_compare_legacy_form(written_pair):
    assert compare.main([*written_pair, "--rtol", "0.02"]) == 0
    assert compare.main([*written_pair, "--rtol", "1e-8"]) == 1


def test_compare_full_form(written_pair, tmp_path):
    ref_p, test_p = written_pair
    outdir = str(tmp_path / "out")
    rc = compare.main([
        "--ref", ref_p, "--ref-label", "a",
        "--test", test_p, "--test-label", "b",
        "--combine", "numu*",  # numu_cc + numubar_cc
        "--combine", "nue*",   # single match keeps its own name
        "--sum", "reco_coszen",
        "--outdir", outdir, "--json", "--png",
        "--fract-diff-max", "0.02",
        "--rtol", "0.02",
    ])
    assert rc == 0
    files = os.listdir(outdir)
    with open(os.path.join(outdir, "b__vs__a.summary.json")) as f:
        summary = json.load(f)
    assert summary["numu_numubar_cc"]["allclose"]
    assert "b__vs__a.diff.json.bz2" in files
    assert any(f.endswith(".png") for f in files)
    diff = MapSet.from_json(os.path.join(outdir, "b__vs__a.diff.json.bz2"))
    assert set(diff.names) == {"numu_numubar_cc", "nue_cc"}
    assert diff["numu_numubar_cc"].binning.names == ["reco_energy"]


def test_compare_sum_of_sources_and_pipeline_input(mapset_pair, tmp_path,
                                                   jax_toy_outputs):
    """Repeated --ref is summed; a pipeline config runs on --device."""
    ref, _ = mapset_pair
    half = str(tmp_path / "half.json.bz2")
    ref.to_json(half)
    whole = str(tmp_path / "whole.json.bz2")
    MapSet([m + m for m in ref], name="whole").to_json(whole)
    assert compare.main(["--ref", half, "--ref", half, "--test", whole]) == 0
    assert compare.main(["--ref", jax_toy_outputs, "--test", TOY,
                         "--rtol", str(MAP_RTOL), *CPU]) == 0


def test_compare_missing_and_extra_maps(binning, tmp_path):
    paths = []
    for name in ("numu_cc", "nue_cc"):
        paths.append(str(tmp_path / f"{name}.json"))
        MapSet([Map(name=name, hist=np.ones(binning.shape), binning=binning)],
               name=name).to_json(paths[-1])
    assert compare.main(paths) == 1


# -- analysis ----------------------------------------------------------------------
def _free_rescaled(path, param_set_cls, read):
    free = param_set_cls.from_state(read(path)["params"]).free
    return free.names, np.asarray(free._rescaled_values, dtype=np.float64)


def test_analysis_fit_matches_jax(tmp_path, capsys):
    """Both commands fit toy_flux_fit.cfg from its nominal to data made at
    theta23 = 0.85 (nominal 0.95) and aeff_scale = 1.1 (1.0)."""
    from pisa_tpu.core.param import ParamSet as JaxParamSet
    from pisa_tpu.utils.fileio import from_file as jax_from_file

    dm = JaxDistributionMaker([FLUX])
    dm.params["theta23"].value = 0.85
    dm.params["aeff_scale"].value = 1.1
    data = str(tmp_path / "data.json")
    dm.get_outputs(return_sum=True).to_json(data)
    jax_out, port_out = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    args = ["-p", FLUX, "--data", data]
    assert jax_analysis.main(args + ["-o", jax_out]) == 0
    capsys.readouterr()
    assert analysis.main(args + ["-o", port_out, *CPU]) == 0
    out = capsys.readouterr().out
    assert "best-fit mod_chi2:" in out and f"wrote {port_out}" in out
    names, got = _free_rescaled(port_out, ParamSet, from_file)
    jax_names, want = _free_rescaled(jax_out, JaxParamSet, jax_from_file)
    assert names == jax_names
    np.testing.assert_allclose(got, want, rtol=0, atol=FIT_X_ATOL)
    truth = ParamSet.from_state(from_file(port_out)["params"])
    assert truth["theta23"].value.m == pytest.approx(0.85, abs=1e-4)


# -- benchmark ---------------------------------------------------------------------
BENCH_LINE = re.compile(
    r"^(?P<cfg>\S+): avg (?P<avg>[\d.]+) ms \| min (?P<min>[\d.]+) ms \|"
    r" max (?P<max>[\d.]+) ms \| (?P<rate>[\d.]+) templates/s$", re.M)


@pytest.mark.parametrize("route", [[], ["--in-device"], ["--eager"]],
                         ids=["captured", "in-device", "eager"])
def test_benchmark_prints_a_line_that_parses(capsys, route):
    assert benchmark.main([FLUX, "-n", "3", *route, *CPU]) == 0
    lines = BENCH_LINE.findall(capsys.readouterr().out)
    assert len(lines) == 1
    cfg, avg, lo, hi, rate = lines[0]
    assert cfg == FLUX
    assert 0 < float(lo) <= float(avg) <= float(hi)
    assert float(rate) == pytest.approx(1e3 / float(avg), rel=1e-2)


# -- convert_config ------------------------------------------------------------------
def _packaged_configs():
    return sorted(glob.glob(os.path.join(
        ROOT, "pisa_tpu", "resources", "settings", "**", "*.cfg"),
        recursive=True))


def _gating(notes):
    return [n for n in notes if n.startswith("NOTE: service")]


def test_convert_text_matches_jax_on_packaged_configs():
    configs = _packaged_configs()
    assert len(configs) >= 14
    for path in configs:
        text = open(path).read()
        out, notes = convert_config.convert_text(text)
        jax_out, jax_notes = jax_convert_config.convert_text(text)
        assert out == jax_out, path
        assert [n for n in notes if n not in _gating(notes)] == [
            n for n in jax_notes if n not in _gating(jax_notes)], path
        assert not _gating(notes), path  # the port runs every packaged one


def test_convert_gates_what_the_port_cannot_run(tmp_path, capsys):
    """The port has every service of the JAX package, and GATED lists those
    that run only with an external package (the port's matrix skips them
    for it here); a reference-style config naming them is rewritten and
    noted, and the rewritten flagship parses with --check."""
    assert sorted(discover_services()) == sorted(jax_discover_services())
    for name in convert_config.GATED:
        assert run_service(*name.split("."), "events", device="cpu") \
            .startswith("skip: could not import"), name
    text = ("[pipeline]\norder = data.pi_meows_loader, flux.pi_airs,"
            " osc.pi_prob3\n#include pisa_examples/resources/settings/"
            "binning/example.cfg as binning\n")
    out, notes = convert_config.convert_text(text)
    assert out == jax_convert_config.convert_text(text)[0]
    assert "pi_" not in out and "pisa_examples" not in out
    # data.meows_loader runs in the port: flux.airs is the gated example
    assert _gating(notes) == [
        "NOTE: service 'flux.airs' requires an external package and is"
        " import-gated in pisa_tpu_torch"]
    outfile = str(tmp_path / "converted.cfg")
    convert_config.main([find_resource(
        "settings/pipeline/IceCube_3y_neutrinos.cfg"), outfile, "--check"])
    assert "# parse check: OK" in capsys.readouterr().err


# -- run_unit_tests, test_services -----------------------------------------------------
def test_run_unit_tests_suites_exist():
    repo = run_unit_tests._tests_dir()
    assert os.path.samefile(repo, ROOT)
    for suite in run_unit_tests.SUITES:
        files = run_unit_tests.suite_files(suite, repo)
        assert files and all(
            re.fullmatch(r"tests/test_torch_\w+\.py", f)
            and os.path.isfile(os.path.join(repo, f)) for f in files), suite
    assert os.path.basename(__file__) in " ".join(
        run_unit_tests.suite_files("cli", repo))


def test_test_services_markdown_and_exit_code(tmp_path, capsys):
    outfile = str(tmp_path / "matrix.md")
    with pytest.raises(SystemExit) as exit_:
        test_services.main(["--outfile", outfile, *CPU])
    assert exit_.value.code == 0
    out = capsys.readouterr().out
    services = discover_services()
    assert re.search(rf"^{len(services)} services: \d+ ok \(events mode\),"
                     r" 0 failing$", out, re.M)
    md = open(outfile).read()
    assert md.startswith("| service | events mode | map mode |\n|---|---|---|")
    rows = md.strip().splitlines()[2:]
    assert [r.split(" | ")[0][2:] for r in rows] == [
        f"{s}.{v}" for s, v in sorted(services)]
    assert "| osc.prob3 |" in md and "✗" not in md


# -- pyproject.toml ------------------------------------------------------------------
def test_entry_points_name_modules_with_main():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    port = {k: v for k, v in scripts.items()
            if k.startswith("pisa-tpu-torch-")}
    assert len(port) == 15
    for name, target in port.items():
        module, _, attr = target.partition(":")
        assert module.startswith("pisa_tpu_torch.scripts."), name
        assert callable(getattr(importlib.import_module(module), attr)), name
        # each names the port's counterpart of a pisa-tpu-* command
        jax_target = scripts[name.replace("pisa-tpu-torch-", "pisa-tpu-")]
        assert jax_target == target.replace("pisa_tpu_torch.", "pisa_tpu."), \
            name
