"""
The port's multi-device evaluation (``pisa_tpu_torch/parallel``,
``CompiledTemplate.shard``) on the CPU: one gloo world of 3 processes
(``pisa_tpu_torch/testing/sharded_worker.py``, started once for the module)
runs every case, in float64, beside the JAX package's references, which
this process computes meanwhile on conftest's 8 virtual CPU devices.

- toy_fit_example (a template per container, all binned) sharded over 2
  ranks against the unsharded port (1e-12) and the JAX sharded template
  (``tests/test_sharding.py:47``'s bounds);
- the flagship at 20x20 grid points and 0.05005 of its events (1001 in the
  largest category, which divides by neither 2 nor 3, so that ``shard``
  stacks again with ``pad_multiple``): sharded over 2 ranks with the calc
  grid split as well (``grid_min`` 1), over 3 with the grid whole (400
  points do not divide by 3), and per container over 3. Template and errors
  to 1e-12 of the unsharded port, the mod_chi2 value and every gradient
  entry, all 15 params free, to 1e-12; the unsharded port against the JAX
  package's unsharded template and gradient within ``tests/
  test_torch_template.py``'s bounds; the pipeline's eager outputs unchanged
  by ``shard``;
- the multihost sum of P(numu -> numu) over 64 events against the JAX
  ``osc_probs_layers`` value; ``build_batched_objective`` over 2 ranks at 8
  walkers against ``value_only`` and the JAX batched objective; an
  objective built before ``shard()``; ``default_mesh`` without a process
  group and beyond the world.
"""

import os

import numpy as np
import pytest

from pisa_tpu import ureg as jax_ureg
from pisa_tpu.config.parser import parse_pipeline_config as jax_parse
from pisa_tpu.core import binning as jax_binning
from pisa_tpu.core.pipeline import Pipeline as JaxPipeline
from pisa_tpu.parallel import build_batched_objective as jax_batched
from pisa_tpu.parallel import default_mesh as jax_default_mesh
from pisa_tpu_torch.testing.sharded_worker import start_world
from test_torch_pipeline import _small_grid_config
from test_torch_template import GRAD_ATOL_FRACTION, GRAD_RTOL, VALUE_RTOL

WORLD = 3
GRID_BINS = 20
#: 0.05005 keeps 1001 events of the largest category's 20,000
FRACTION = 0.05005
TOY = "settings/pipeline/toy_fit_example.cfg"
SHARDED = ("grid2", "world3", "percontainer3")
#: one of each kind of free param: a Barr flux param and an oscillation
#: param before the reduction, a hypersurface param after it
NAMED = ("Barr_uphor_ratio", "theta23", "opt_eff_overall")
PORT_RTOL = 1e-12


def _jax_flagship():
    config = _small_grid_config(jax_parse, jax_binning, jax_ureg)
    config[("data", "csv_loader")]["fraction_events_to_keep"] = FRACTION
    return JaxPipeline(config).compile()


def _jax_references():
    """The JAX package's side, computed while the ranks run: toy_fit_example
    sharded over the 8 virtual devices, its batched objective at 8 walkers,
    the 64-event sum, and the unsharded flagship with its objective (its
    gradient compiled here, at the nominal point)."""
    from pisa_tpu.ops.osc.kernels import osc_probs_layers
    from pisa_tpu.ops.osc.pmns import dm_matrix, pmns_matrix_complex

    refs = {}
    toy = JaxPipeline(TOY).compile().shard(jax_default_mesh())
    refs["toy_names"] = list(toy.names)
    refs["toy"] = toy(toy.current_rescaled_values())["hist"]
    toy = JaxPipeline(TOY).compile()
    refs["toy_free"] = list(toy.free_names)
    batched = jax_batched(toy, toy.get_outputs(), "mod_chi2",
                          mesh=jax_default_mesh())
    vecs = np.random.RandomState(7).uniform(0.2, 0.8,
                                            size=(8, len(toy.free_names)))
    refs["batched"] = np.asarray(batched(vecs))

    rng = np.random.default_rng(7)
    n = 64
    energy = rng.uniform(1.0, 80.0, n)
    densities = rng.uniform(1.0, 10.0, (n, 3))
    distances = rng.uniform(100.0, 4000.0, (n, 3))
    probs = np.asarray(osc_probs_layers(
        dm_matrix(7.42e-5, 2.514e-3),
        pmns_matrix_complex(np.sin(0.5839), np.sin(0.1496), np.sin(0.7854),
                            1.2),
        np.diag([1.0, 0.0, 0.0]).astype(complex), np.zeros((3, 3), complex),
        np.zeros((3, 3)), 1, energy, densities, distances))
    refs["multihost"] = float(probs[:, 1, 1].sum())

    ct = _jax_flagship()
    v0 = np.asarray(ct.current_rescaled_values())
    maps = ct.get_outputs(v0)
    refs["flagship"] = {m.name: (np.asarray(m.hist), np.asarray(m.error_hist))
                        for m in maps}
    _, vg = ct.build_objective({m.name: np.asarray(m.hist) for m in maps},
                               "mod_chi2")
    vg(np.clip(v0, 0.15, 0.85))  # compiles the gradient
    refs["flagship_free"] = list(ct.free_names)
    refs["flagship_vg"] = vg
    return refs


@pytest.fixture(scope="module")
def world():
    """(each rank's results, the JAX references)."""
    env = dict(os.environ, PISA_TPU_FTYPE="fp64", OMP_NUM_THREADS="1")
    ranks = start_world(
        {"device": "cpu", "backend": "gloo", "grid_bins": GRID_BINS,
         "fraction": FRACTION,
         "cases": ["toy", "flagship", "multihost", "batched", "stale"]},
        WORLD, env=env)
    refs = _jax_references()
    return ranks.results(timeout=900), refs


def _jax_value_and_grad(refs, names, v):
    """The JAX unsharded flagship's value and gradient at the port's
    rescaled vector `v` (in the order of `names`), in that order."""
    order = [list(names).index(n) for n in refs["flagship_free"]]
    value, grad = refs["flagship_vg"](np.asarray(v)[order])
    grad = np.asarray(grad)
    back = [refs["flagship_free"].index(n) for n in names]
    return float(value), grad[back]


def test_no_rank_failed(world):
    ranks, _ = world
    assert len(ranks) == WORLD
    errors = {f"rank {r}: {k}": v for r, out in enumerate(ranks)
              for k, v in out.items() if k.endswith("|error")}
    assert not errors, "\n".join(f"{k}\n{v}" for k, v in errors.items())


def test_default_mesh_needs_a_process_group():
    """Without an initialised process group ``default_mesh`` raises and
    names ``init_multihost``; it never makes a world of one."""
    import torch.distributed as dist

    from pisa_tpu_torch.parallel import default_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_multihost"):
        default_mesh()
    assert not dist.is_initialized()


def test_default_mesh_raises_beyond_the_world(world):
    ranks, _ = world
    for out in ranks:
        assert "need 4 ranks; the process group has 3" in out["stale|too_many"]


def test_toy_sharded_matches_port_and_jax(world):
    ranks, refs = world
    for out in ranks[:2]:
        assert not out["toy|stacked"]
        np.testing.assert_allclose(out["toy|sharded"], out["toy|unsharded"],
                                   rtol=PORT_RTOL, atol=0)
        want = np.stack([np.asarray(refs["toy"][n]).reshape(-1)
                         for n in refs["toy_names"]])
        np.testing.assert_allclose(out["toy|sharded"].reshape(want.shape),
                                   want, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(out["toy|sharded|value"],
                                   out["toy|unsharded|value"],
                                   rtol=PORT_RTOL)
        g0 = out["toy|unsharded|grad"]
        np.testing.assert_allclose(out["toy|sharded|grad"], g0,
                                   rtol=PORT_RTOL,
                                   atol=PORT_RTOL * np.abs(g0).max())


def test_flagship_stacks_again_with_pad_multiple(world):
    """1001 events in the largest category: ``shard`` pads the stacked
    event axis to 1002 for both 2 and 3 ranks, and each rank holds its
    equal slice."""
    ranks, _ = world
    for rank, out in enumerate(ranks):
        assert out["flagship|n_pad"] == 1001
        for tag in SHARDED:
            world = 2 if tag == "grid2" else 3
            if rank >= world:
                continue
            tag = f"flagship|{tag}"
            assert out[f"{tag}|n_events"] == 1002, tag
            per = 1002 // world
            np.testing.assert_array_equal(out[f"{tag}|events"],
                                          [rank * per, (rank + 1) * per])


def test_flagship_grid_split_only_where_it_divides(world):
    ranks, _ = world
    for rank, out in enumerate(ranks):
        if rank < 2:
            np.testing.assert_array_equal(out["flagship|grid2|grid"],
                                          [[rank * 200, (rank + 1) * 200]])
        assert out["flagship|world3|grid"].size == 0
        assert out["flagship|grid2|stacked" if rank < 2
                   else "flagship|world3|stacked"]
        assert not out["flagship|percontainer3|stacked"]


@pytest.mark.parametrize("tag", SHARDED)
def test_flagship_sharded_template_matches_port(world, tag):
    """Template and errors (the root of the summed sumw2) to 1e-12."""
    ranks, _ = world
    for rank, out in enumerate(ranks[:2 if tag == "grid2" else 3]):
        for key in ("hist", "errors"):
            np.testing.assert_allclose(
                out[f"flagship|{tag}|{key}"],
                out[f"flagship|unsharded|{key}"], rtol=PORT_RTOL, atol=0,
                err_msg=f"rank {rank} {tag} {key}")


@pytest.mark.parametrize("tag", SHARDED)
def test_flagship_sharded_scan_totals_sum_over_ranks(world, tag):
    """``scan_totals`` of a sharded template gives the whole template's
    totals on every rank."""
    ranks, _ = world
    for rank, out in enumerate(ranks[:2 if tag == "grid2" else 3]):
        np.testing.assert_allclose(out[f"flagship|{tag}|totals"],
                                   out["flagship|unsharded|totals"],
                                   rtol=PORT_RTOL, err_msg=f"rank {rank}")


@pytest.mark.parametrize("tag", SHARDED)
def test_flagship_sharded_gradient_matches_port(world, tag):
    """mod_chi2's value and every gradient entry, the 10 params before the
    reduction and the 5 hypersurface params after it, to 1e-12 on every
    rank."""
    ranks, _ = world
    for rank, out in enumerate(ranks[:2 if tag == "grid2" else 3]):
        names = list(out["flagship|free"])
        assert len(names) == 15 and set(NAMED) <= set(names)
        np.testing.assert_allclose(out[f"flagship|{tag}|value"],
                                   out["flagship|unsharded|value"],
                                   rtol=PORT_RTOL)
        got, want = out[f"flagship|{tag}|grad"], out["flagship|unsharded|grad"]
        bad = np.abs(got - want) > PORT_RTOL * np.abs(want) + 1e-300
        named = {n: (got[names.index(n)], want[names.index(n)])
                 for n in NAMED}
        assert not bad.any(), (
            f"rank {rank} {tag}: entries {np.asarray(names)[bad].tolist()}"
            f" differ; (sharded, unsharded) of {named}")


def test_flagship_port_matches_jax_unsharded(world):
    """The port's template and gradient (unsharded, which the sharded ones
    match above) against the JAX package's unsharded ones."""
    ranks, refs = world
    out = ranks[0]
    want = refs["flagship"]
    names = sorted(want)
    port_names = ["nue_cc", "numu_cc", "nutau_cc", "nue_nc", "numu_nc",
                  "nutau_nc", "nuebar_cc", "numubar_cc", "nutaubar_cc",
                  "nuebar_nc", "numubar_nc", "nutaubar_nc"]
    assert sorted(port_names) == names
    for i, name in enumerate(port_names):
        np.testing.assert_allclose(out["flagship|unsharded|hist"][i],
                                   want[name][0], rtol=VALUE_RTOL, atol=0,
                                   err_msg=name)
        np.testing.assert_allclose(out["flagship|unsharded|errors"][i],
                                   want[name][1], rtol=VALUE_RTOL, atol=0,
                                   err_msg=name)
    free = list(out["flagship|free"])
    value, grad = _jax_value_and_grad(refs, free, out["flagship|v"])
    for tag in ("unsharded",) + SHARDED:
        np.testing.assert_allclose(out[f"flagship|{tag}|value"], value,
                                   rtol=VALUE_RTOL, err_msg=tag)
        got = out[f"flagship|{tag}|grad"]
        np.testing.assert_allclose(
            got, grad, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_FRACTION * np.abs(grad).max(),
            err_msg=f"{tag}: " + ", ".join(
                f"{n} {got[free.index(n)]:.6e} vs {grad[free.index(n)]:.6e}"
                for n in NAMED))


def test_eager_outputs_unchanged_by_shard(world):
    ranks, _ = world
    for out in ranks:
        np.testing.assert_array_equal(out["flagship|eager_after"],
                                      out["flagship|eager_before"])


def test_multihost_ranks_agree_and_match_jax(world):
    ranks, refs = world
    values = [out["multihost|value"] for out in ranks[:2]]
    assert values[0] == pytest.approx(values[1], rel=1e-12)
    assert values[0] == pytest.approx(refs["multihost"], rel=1e-10)
    for rank, out in enumerate(ranks[:2]):
        np.testing.assert_array_equal(out["multihost|slice"],
                                      [32 * rank, 32 * (rank + 1)])
        np.testing.assert_array_equal(out["multihost|block"], [32 * rank, 32])


def test_process_local_slice_raises_on_an_indivisible_length(world):
    ranks, _ = world
    for out in ranks:
        assert "63 not divisible by 2" in out["multihost|indivisible"]


def test_batched_objective_matches_value_only_and_jax(world):
    ranks, refs = world
    for out in ranks[:2]:
        np.testing.assert_allclose(out["batched|values"],
                                   out["batched|value_only"], rtol=1e-12)
        np.testing.assert_allclose(out["batched|local"],
                                   out["batched|value_only"], rtol=1e-12)
        np.testing.assert_allclose(out["batched|values"], refs["batched"],
                                   rtol=1e-8)
        assert "7 walkers do not divide" in out["batched|indivisible"]


def test_objective_built_before_shard_raises(world):
    ranks, _ = world
    for out in ranks:
        for label in ("value", "vg"):
            assert "built before the template was sharded" in \
                out[f"stale|{label}"], label
        np.testing.assert_allclose(out["stale|rebuilt"], out["stale|before"],
                                   rtol=PORT_RTOL)
        assert out["stale|before"] > 0


def test_mesh_device_is_the_callers_and_leaves_with_the_group():
    """In a world of one on gloo: ``default_mesh`` takes the device its
    caller names, takes the card by default (and raises here, where there
    is none, rather than fall back to the CPU), and its ``all_reduce_sum``
    runs the collective; once the group is destroyed it raises again, with
    nothing of the old group kept."""
    import torch
    import torch.distributed as dist

    from pisa_tpu_torch.parallel import default_mesh, multihost
    from pisa_tpu_torch.testing.sharded_worker import free_port

    assert not dist.is_initialized()
    multihost.init_multihost(f"127.0.0.1:{free_port()}", 1, 0, device="cpu")
    try:
        mesh = default_mesh(device="cpu")
        assert mesh.device == torch.device("cpu") and mesh.size == 1
        x = torch.arange(3, dtype=torch.float64, requires_grad=True)
        total = mesh.all_reduce_sum(x)
        total.sum().backward()
        np.testing.assert_array_equal(total.detach().numpy(), [0, 1, 2])
        np.testing.assert_array_equal(x.grad.numpy(), [1, 1, 1])
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                default_mesh()
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="init_multihost"):
        default_mesh(device="cpu")


def test_core_and_stages_import_no_parallel_module():
    """The containers, the stacking, the template and the histogram stage
    reduce over a shard's mesh without importing ``pisa_tpu_torch.
    parallel``, which is built on them."""
    import subprocess
    import sys

    code = ("import sys; import pisa_tpu_torch.core.container, "
            "pisa_tpu_torch.core.stacking, pisa_tpu_torch.core.template, "
            "pisa_tpu_torch.core.collectives, "
            "pisa_tpu_torch.stages.utils.hist; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('pisa_tpu_torch.parallel')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.stdout.strip() == "[]", out.stdout
