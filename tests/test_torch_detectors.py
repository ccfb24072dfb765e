"""
The port's Detectors (``pisa_tpu_torch/core/detectors.py``) and its joint
objective (``analysis/gradient.py:CompiledDetectors``) against the JAX
package's, mirroring tests/test_detectors.py: two detectors built from
``settings/pipeline/toy_fit_example.cfg`` (``nutau_cc_norm`` 0.5 and 0.8),
theta23, deltam31 and theta13 shared, in fp64 on the CPU. The joint
params' names and order, object identity across detectors, the suffixed
proxies, ``shared_param_ind_list``, the joint objective and its gradient,
and the two-detector gradient fit of the shared theta23 (within 1e-6
rescaled of the JAX package's).
"""

import numpy as np
import pytest
import torch

from pisa_tpu import ureg as jax_ureg
from pisa_tpu.analysis.analysis import Analysis as JaxAnalysis
from pisa_tpu.analysis.gradient import CompiledDetectors as JaxCompiled
from pisa_tpu.core.detectors import Detectors as JaxDetectors
from pisa_tpu_torch import ureg
from pisa_tpu_torch.analysis.analysis import Analysis
from pisa_tpu_torch.analysis.gradient import CompiledDetectors
from pisa_tpu_torch.core.detectors import Detectors
from pisa_tpu_torch.utils.resources import find_resource

SHARED = ["theta23", "deltam31", "theta13"]


def _make_det_config(tmp_path, det_name, nutau_norm_value):
    text = open(find_resource("settings/pipeline/toy_fit_example.cfg")).read()
    text = text.replace("name = neutrinos",
                        f"name = neutrinos\ndetector_name = {det_name}")
    text = text.replace("param.nutau_cc_norm = 0.5",
                        f"param.nutau_cc_norm = {nutau_norm_value}")
    path = tmp_path / f"{det_name}.cfg"
    path.write_text(text)
    return str(path)


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("detcfg")
    return [_make_det_config(tmp_path, "detA", 0.5),
            _make_det_config(tmp_path, "detB", 0.8)]


@pytest.fixture(scope="module")
def detectors(configs):
    return (JaxDetectors(configs, shared_params=SHARED),
            Detectors(configs, shared_params=SHARED, device="cpu"))


def test_joint_params_match(detectors):
    jax_det, det = detectors
    assert det.det_names == jax_det.det_names == ["detA", "detB"]
    assert list(det.params.names) == list(jax_det.params.names)
    assert list(det.params.free.names) == list(jax_det.params.free.names)
    names = det.params.names
    assert names.count("theta23") == 1
    assert "aeff_scale" in names and "aeff_scale_detB" in names
    assert "aeff_scale_detA" not in names
    assert det.shared_param_ind_list == jax_det.shared_param_ind_list
    assert det.param_selections == jax_det.param_selections


def test_shared_params_are_one_object(detectors):
    _, det = detectors
    dms = det.distribution_makers
    p1, p2 = dms[0].params["theta23"], dms[1].params["theta23"]
    assert p1 is p2 and det.params["theta23"] is p1
    saved = p1.value
    try:
        det.params["theta23"].value = 44.0 * ureg.degree
        assert dms[1].params["theta23"].value.m_as("degree") == (
            pytest.approx(44.0))
    finally:
        p1.value = saved


def test_suffixed_param_forwards(detectors):
    _, det = detectors
    dms = det.distribution_makers
    joint = det.params["aeff_scale_detB"]
    saved = joint.value
    try:
        joint.value = 1.5
        assert dms[1].params["aeff_scale"].value.magnitude == (
            pytest.approx(1.5))
        assert dms[0].params["aeff_scale"].value.magnitude != (
            pytest.approx(1.5))
    finally:
        joint.value = saved


def test_outputs_match(detectors):
    jax_det, det = detectors
    want = jax_det.get_outputs(return_sum=True)
    got = det.get_outputs(return_sum=True)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0].hist, w[0].hist, rtol=1e-9, atol=0)


def test_joint_objective_matches(detectors):
    """CompiledDetectors: the joint value and gradient (priors counted once
    for the shared params), off the data's point."""
    jax_det, det = detectors
    datas = [d.get_outputs(return_sum=True) for d in detectors]
    for d, u in zip(detectors, (jax_ureg, ureg)):
        d.params["theta23"].value = 40.0 * u.degree
    try:
        jax_cd, cd = JaxCompiled(jax_det), CompiledDetectors(det)
        assert cd.free_names == list(jax_cd.free_names)
        for got, want in zip(cd.index_maps, jax_cd.index_maps):
            np.testing.assert_array_equal(got, want)
        x = cd.current_rescaled_values()
        _, jax_vg = jax_cd.build_objective(datas[0], "mod_chi2")
        _, vg = cd.build_objective(datas[1], "mod_chi2")
        assert cd.build_objective(datas[1], "mod_chi2")[1] is vg
        want_v, want_g = (np.asarray(a) for a in jax_vg(x))
        value, grad = vg(x)
        np.testing.assert_allclose(float(value), float(want_v), rtol=1e-9)
        assert np.abs(grad.numpy() - want_g).max() <= (
            1e-7 * np.abs(want_g).max())
    finally:
        for d in detectors:
            d.reset_free()


def test_two_detector_gradient_fit_matches(detectors):
    """The joint compiled objective with analytic gradients recovers the
    shared theta23 as the JAX package's does (everything else fixed)."""
    results = []
    for d, u, analysis in zip(detectors, (jax_ureg, ureg),
                              (JaxAnalysis, Analysis)):
        fixed_now = [p for p in d.params.free if p.name != "theta23"]
        for p in fixed_now:
            p.is_fixed = True
        truth = d.params["theta23"].value
        data = d.get_outputs(return_sum=True)
        try:
            d.params["theta23"].value = 44.0 * u.degree
            result = analysis().fit_recursively(
                data, d, "mod_chi2", None, "gradient", {}, None)
        finally:
            d.params["theta23"].value = truth
            for p in fixed_now:
                p.is_fixed = False
        fitted = result.params["theta23"].value.m_as("degree")
        assert fitted == pytest.approx(truth.m_as("degree"), abs=0.5)
        results.append(result)
    jax_result, result = results
    assert result.minimizer_metadata["nfev"] == (
        jax_result.minimizer_metadata["nfev"])
    assert list(result.params.free.names) == ["theta23"]
    np.testing.assert_allclose(
        np.asarray(result.params.free._rescaled_values),
        np.asarray(jax_result.params.free._rescaled_values), rtol=0,
        atol=1e-6)


@pytest.mark.cuda
def test_compiled_detectors_capture_one_program(configs):
    """On the card, the joint objective over both detectors is one captured
    program, equal to the eager one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    from pisa_tpu_torch.core import template as template_module

    det = Detectors(configs, shared_params=SHARED, device="cuda")
    datas = det.get_outputs(return_sum=True)
    det.params["theta23"].value = 40.0 * ureg.degree
    captured = []
    original = template_module._CapturedProgram._capture

    def spy(self, fn):
        captured.append(type(self).__name__)
        return original(self, fn)

    template_module._CapturedProgram._capture = spy
    try:
        cd = CompiledDetectors(det)
        value_fn, vg = cd.build_objective(datas, "mod_chi2")
    finally:
        template_module._CapturedProgram._capture = original
    assert captured == ["CapturedObjective", "CapturedObjective"]
    _, eager_vg = CompiledDetectors(det, capture=False).build_objective(
        datas, "mod_chi2")
    x = cd.current_rescaled_values()
    v, g = (t.cpu().numpy() for t in vg(x))
    ve, ge = (t.cpu().numpy() for t in eager_vg(x))
    np.testing.assert_allclose(v, ve, rtol=1e-12)
    assert np.abs(g - ge).max() <= 1e-12 * np.abs(ge).max()
