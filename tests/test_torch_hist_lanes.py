"""
Lanes (``container.lanes``: the B parameter points of a batch fit, an
ensemble or an MCMC, evaluated in one program) through the two routes that
raised before, against the JAX package's batched route (``jax.vmap`` of its
compiled template, as ``pisa_tpu/analysis/device_fit.py:223-224`` runs a
batch), per lane, in float64 on the CPU:

- the scatter-added histogram of a container past the one-hot budget:
  ``example.cfg`` (prob3's calc grid cut to 20x20) histogrammed into a
  16 x 20 x 2 = 640-bin reco binning, run per container: one
  ``index_add_`` along the bins of every lane
  (``core/translation.py:histogram``, ``laned=True``); maps and errors
  within 1e-10 relative;
- map-to-map resampling: ``toy_fit_example.cfg`` with prob3 on a 20 x 20
  grid and applied on the 24 x 24 ``calc_grid_coarse``, so its
  probabilities are resampled between the two binnings with the lane axis
  folded into the channels (``core/container.py:translate``); the JAX
  package runs ``translation.resample`` under ``vmap``. Within 1e-10.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pisa_tpu import ureg as jax_ureg
from pisa_tpu.config.parser import parse_pipeline_config as jax_parse
from pisa_tpu.core import binning as jax_binning
from pisa_tpu.core.pipeline import Pipeline as JaxPipeline
from pisa_tpu_torch import ureg
from pisa_tpu_torch.config.parser import parse_pipeline_config
from pisa_tpu_torch.core import binning, translation
from pisa_tpu_torch.core.pipeline import Pipeline

LANES = 4
RTOL = 1e-10


def _grid(b, units, name, n=20):
    return b.MultiDimBinning([
        b.OneDimBinning("true_energy", num_bins=n, is_log=True,
                        domain=[1, 1000] * units.GeV),
        b.OneDimBinning("true_coszen", num_bins=n, is_lin=True,
                        domain=[-1, 1]),
    ], name=name)


def _fine_example(parse, b, units):
    """example.cfg histogrammed into 640 reco bins."""
    cfg = parse("settings/pipeline/example.cfg")
    cfg[("osc", "prob3")]["calc_mode"] = _grid(b, units, "calc_grid")
    fine = b.MultiDimBinning([
        b.OneDimBinning("reco_energy", num_bins=16, is_log=True,
                        domain=[5, 100] * units.GeV),
        b.OneDimBinning("reco_coszen", num_bins=20, is_lin=True,
                        domain=[-1, 1]),
        b.OneDimBinning("pid", bin_edges=[-1000.0, 0.0, 1000.0]),
    ], name="fine_reco")
    cfg["pipeline"]["output_binning"] = fine
    cfg[("utils", "hist")]["apply_mode"] = fine
    return cfg


def _resampled_toy(parse, b, units):
    """toy_fit_example.cfg with prob3 computed on another grid than the
    one it applies on."""
    cfg = parse("settings/pipeline/toy_fit_example.cfg")
    cfg[("osc", "prob3")]["calc_mode"] = _grid(b, units, "osc_grid")
    return cfg


CASES = {"scatter_histogram": _fine_example, "resampling": _resampled_toy}


def _lanes_of(x0, seed):
    rng = np.random.RandomState(seed)
    return np.clip(x0 + rng.uniform(-0.05, 0.05, (LANES, x0.size)), 0, 1)


def _jax_batch(make_cfg):
    """The JAX package's compiled template under jax.vmap at seeded lanes
    around the nominal point: (lanes, {label: {name: (B, size)}})."""
    ct = JaxPipeline(make_cfg(jax_parse, jax_binning, jax_ureg)).compile()
    vecs = _lanes_of(ct.current_rescaled_values(), 13)
    los, his = (jnp.asarray(v) for v in ct._current_bounds())
    out = jax.vmap(lambda v: ct._jitted(v, los, his, ct._data_vals))(
        jnp.asarray(vecs))
    return vecs, {label: {k: np.asarray(v) for k, v in out[label].items()}
                  for label in ("hist", "error") if label in out}


@pytest.mark.parametrize("case", list(CASES))
def test_lanes_match_jax_vmap(case, monkeypatch):
    """Each lane of the port's laned evaluation (per container) against
    the JAX vmap's, RTOL relative to the lane's largest bin; the route
    under test ran with the lane axis."""
    vecs, want = _jax_batch(CASES[case])
    calls = []
    for name in ("histogram", "resample"):
        fn = getattr(translation, name)

        def spy(*args, _fn=fn, _name=name, **kwargs):
            weights = args[0] if _name == "resample" else args[1]
            calls.append((_name, kwargs.get("laned", False),
                          None if weights is None else tuple(weights.shape)))
            return _fn(*args, **kwargs)
        monkeypatch.setattr(translation, name, spy)

    ct = Pipeline(CASES[case](parse_pipeline_config, binning, ureg),
                  device="cpu").compile(stack=False)
    assert not ct.stacked
    calls.clear()
    out = ct._evaluate(ct._magnitudes_from_rescaled(torch.tensor(vecs)),
                       lanes=LANES)
    if case == "scatter_histogram":
        assert ct.output_binning.size > 512  # past the one-hot budget
        assert any(name == "histogram" and laned and shape[0] == LANES
                   for name, laned, shape in calls)
    else:
        # the lane axis folded into the resampled values' channels
        assert any(name == "resample" and len(shape) == 2
                   and shape[1] % LANES == 0 for name, _, shape in calls)
    for label, maps in want.items():
        assert sorted(out[label]) == sorted(maps), label
        for name, ref in maps.items():
            got = out[label][name].detach().numpy()
            assert got.shape == ref.shape == (LANES, ref.shape[1])
            for lane in range(LANES):
                scale = np.max(np.abs(ref[lane]))
                assert scale > 0
                np.testing.assert_allclose(got[lane], ref[lane], rtol=RTOL,
                                           atol=RTOL * scale,
                                           err_msg=f"{label} {name} {lane}")
            # the lanes differ from one another
            assert not np.allclose(ref[0], ref[-1], rtol=1e-9)


def test_laned_scatter_equals_unlaned_calls():
    """translation.histogram with lanes: each lane equals its own unlaned
    scatter, (B, N) and (B, N, ch) weights, averaged or not."""
    rng = np.random.RandomState(4)
    n, size = 300, 700
    idx = torch.tensor(rng.randint(0, size + 1, n))  # size: out of range
    for shape in ((LANES, n), (LANES, n, 3)):
        w = torch.tensor(rng.normal(size=shape))
        for averaged in (False, True):
            got = translation.histogram(None, w, [{"num_bins": size}],
                                        averaged=averaged, idx=idx,
                                        laned=True)
            for lane in range(LANES):
                want = translation.histogram(None, w[lane],
                                             [{"num_bins": size}],
                                             averaged=averaged, idx=idx)
                assert torch.equal(got[lane], want)
