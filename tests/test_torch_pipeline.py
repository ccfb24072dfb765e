"""
The port's flagship pipeline (``pisa_tpu_torch``) against the JAX package's
eager ``get_outputs()``: ``settings/pipeline/IceCube_3y_neutrinos.cfg``
parsed by each package, with the ``true_allsky_fine`` oscillation grid cut
from 200x200 to 20x20 over the same domains, all 240k events, weights and
sumw2 errors per bin to 1e-5 relative (the BASELINE.json template target) at
nominal and perturbed parameters. Parameter values reach the port through
``pisa_tpu_torch.utils.interop``; the suite runs in fp64 (conftest).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pisa_tpu import ureg as jax_ureg
from pisa_tpu.config.parser import parse_pipeline_config as jax_parse
from pisa_tpu.core import binning as jax_binning
from pisa_tpu.core.pipeline import Pipeline as JaxPipeline
from pisa_tpu_torch import ureg as torch_ureg
from pisa_tpu_torch.config.parser import parse_pipeline_config as torch_parse
from pisa_tpu_torch.core import binning as torch_binning
from pisa_tpu_torch.core.pipeline import Pipeline as TorchPipeline
from pisa_tpu_torch.ops.osc import chain
from pisa_tpu_torch.utils.interop import set_param_values

CFG = "settings/pipeline/IceCube_3y_neutrinos.cfg"
GRID_BINS = 20
RTOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (changes to the JAX pipeline's params, in its units)
POINTS = {
    "nominal": {},
    "theta23": {"theta23": 42.0 * jax_ureg.degree},
    "deltam31": {"deltam31": 2.3e-3 * jax_ureg.eV**2},
    "opt_eff_overall": {"opt_eff_overall": 1.1 * jax_ureg.dimensionless},
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


def _small_grid_config(parse, binning, ureg):
    """The flagship config with true_allsky_fine cut to GRID_BINS^2."""
    config = parse(CFG)
    grid = binning.MultiDimBinning(
        [
            binning.OneDimBinning(
                "true_energy", num_bins=GRID_BINS, is_log=True,
                domain=[1, 1000] * ureg.GeV,
            ),
            binning.OneDimBinning(
                "true_coszen", num_bins=GRID_BINS, is_lin=True,
                domain=[-1, 1],
            ),
        ],
        name="true_allsky_fine",
    )
    for key, settings in config.items():
        if isinstance(key, tuple):
            for mode in ("calc_mode", "apply_mode"):
                if getattr(settings.get(mode), "name", None) == grid.name:
                    settings[mode] = grid
    return config


def _jax_param_values(pipeline):
    return {
        p.name: (p.value.magnitude, str(p.value.units))
        for p in pipeline.params
        if not isinstance(p.value, str)
    }


@pytest.fixture(scope="module")
def pipelines():
    jax_p = JaxPipeline(_small_grid_config(jax_parse, jax_binning, jax_ureg))
    torch_p = TorchPipeline(
        _small_grid_config(torch_parse, torch_binning, torch_ureg),
        device="cpu",
    )
    nominal = {p.name: p.value for p in jax_p.params}
    return jax_p, torch_p, nominal


def _assert_close(want, got):
    assert [m.name for m in want] == [m.name for m in got]
    for jm in want:
        tm = got[jm.name]
        np.testing.assert_allclose(
            tm.hist, np.asarray(jm.hist), rtol=RTOL, atol=0, err_msg=jm.name
        )
        np.testing.assert_allclose(
            tm.error_hist, np.asarray(jm.error_hist), rtol=RTOL, atol=0,
            err_msg=jm.name,
        )


@pytest.mark.parametrize("point", list(POINTS))
def test_port_matches_jax_pipeline(pipelines, point):
    jax_p, torch_p, nominal = pipelines
    for name, value in nominal.items():
        jax_p.params[name].value = value
    for name, value in POINTS[point].items():
        jax_p.params[name].value = value
    set_param_values(torch_p, _jax_param_values(jax_p))
    want = jax_p.get_outputs()
    got = torch_p.get_outputs()
    assert len(got) == 12
    for m in got:
        assert m.hist.shape == (8, 8, 2)
        assert np.all(np.isfinite(m.hist)) and np.all(m.hist >= 0)
    _assert_close(want, got)


def test_tile_table_built_at_setup(pipelines, monkeypatch):
    """prob3 builds the kernels' tile table once, at set-up: it sits in the
    stage's geometry, equals the table of its sorted layer chains, and a
    template with new oscillation parameters builds none."""
    _, torch_p, _ = pipelines
    stage = torch_p["osc.prob3"]
    tiles = stage.geom["tiles"]
    order = stage.geom["order"].numpy()
    shape = (order.size, stage.layers.max_layers)
    want = chain.tile_table(
        stage.layers.density.reshape(shape)[order],
        stage.layers.distance.reshape(shape)[order],
        dtype=stage.geom["e"].dtype, device="cpu",
    )
    assert tiles.keys() == want.keys()
    for key, value in want.items():
        assert torch.equal(tiles[key], value), key

    def rebuilt(*args, **kwargs):
        raise AssertionError("tile table built after set-up")

    monkeypatch.setattr(chain, "tile_table", rebuilt)
    theta23 = torch_p.params["theta23"].value
    try:
        torch_p.params["theta23"].value = 43.0 * torch_ureg.degree
        torch_p.get_outputs()
    finally:
        torch_p.params["theta23"].value = theta23
    assert stage.geom["tiles"] is tiles


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card error cannot occur")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchPipeline(_small_grid_config(torch_parse, torch_binning,
                                         torch_ureg))


def test_import_leaves_out_jax_pandas_h5py():
    """Importing the port, its pipeline, every stage of the slice, the
    compiled template, the metrics and the fit pulls in neither jax nor
    pandas nor h5py."""
    code = (
        "import sys, importlib\n"
        "import pisa_tpu_torch\n"
        "from pisa_tpu_torch.core.pipeline import Pipeline\n"
        "for m in ['data.csv_loader', 'flux.honda_ip', 'flux.barr_simple',"
        " 'osc.prob3', 'aeff.aeff', 'utils.hist',"
        " 'discr_sys.hypersurfaces']:\n"
        "    importlib.import_module('pisa_tpu_torch.stages.' + m)\n"
        "import pisa_tpu_torch.utils.interop\n"
        "import pisa_tpu_torch.core.template, pisa_tpu_torch.utils.stats\n"
        "import pisa_tpu_torch.analysis.device_fit\n"
        "bad = [m for m in ('jax', 'pisa_tpu', 'pandas', 'h5py')"
        " if m in sys.modules]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.cuda
def test_card_pipeline_matches_cpu(cuda_device):
    """The same port pipeline on the card and on the CPU (fp64): per-bin
    agreement up to summation order (atomics, matmul blocking)."""
    config = _small_grid_config(torch_parse, torch_binning, torch_ureg)
    cpu = TorchPipeline(config, device="cpu").get_outputs()
    card = TorchPipeline(
        _small_grid_config(torch_parse, torch_binning, torch_ureg),
        device=cuda_device,
    ).get_outputs()
    for m in cpu:
        np.testing.assert_allclose(card[m.name].hist, m.hist, rtol=1e-9,
                                   atol=0)
        np.testing.assert_allclose(card[m.name].error_hist, m.error_hist,
                                   rtol=1e-9, atol=0)
