"""
One rank of a sharded evaluation, for the tests and ``chip_smoke.py``.

Each rank joins a process group (:func:`pisa_tpu_torch.parallel.multihost.
init_multihost`), runs the cases its spec names, and writes what it found
to a file of its own (a pickled dict of numpy arrays, numbers and strings;
a case that raises records its traceback under ``<case>|error``). Run one
rank as

    python -m pisa_tpu_torch.testing.sharded_worker SPEC WORLD RANK ADDRESS OUT

with SPEC a JSON file (below), ADDRESS ``host:port`` of rank 0's rendezvous
and OUT the results' path; :func:`start_world` starts every rank of a world
on this host and :meth:`World.results` waits for them.

The spec's keys: ``device`` (``"cpu"`` or ``"cuda:0"``; every rank takes
the same), ``backend`` (``"gloo"`` by default), ``cases`` (names of the
functions below, each run with the spec), ``grid_bins`` (the flagship's
``true_allsky_fine`` cut to that many bins a side, or null for the full
200x200) and ``fraction`` (the flagship's ``fraction_events_to_keep``, or
null for all its events).

Cases:

- ``toy``: ``toy_fit_example.cfg`` unsharded and sharded over the first 2
  ranks (a template that runs per container, with no event axis);
- ``flagship``: the flagship (``IceCube_3y_neutrinos.cfg``, 15 free),
  unsharded, and sharded three ways: stacked over the first 2 ranks with
  the calc grid split (``grid_min`` 1), stacked over the whole world with
  the default ``grid_min``, and per container over the whole world; each
  one's template and errors, its ``scan_totals`` and its mod_chi2 value
  and gradient at a perturbed point; the pipeline's eager outputs before and after; each
  rank's event slice and grid points;
- ``multihost``: P(numu -> numu) summed over 64 events, each rank its
  ``make_global_array`` block through the plain chain, then ``all_reduce``;
  ``process_local_slice`` of an indivisible length;
- ``batched``: ``build_batched_objective`` of toy_fit_example over the
  first 2 ranks at 8 walkers, beside ``value_only`` per walker, and at 7;
- ``stale``: an objective built before ``shard()`` called after it, and
  ``default_mesh`` for more ranks than the world has;
- ``card_flagship``: the full flagship on the card, sharded over the whole
  world with the grid split, eager (gloo), beside the unsharded template on
  rank 0; with each rank's grid points, real layer steps and kernel
  launches.
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

__all__ = ["start_world", "World", "free_port", "flagship_config",
           "PERTURB_SEED"]

#: the seed of the perturbed point the flagship's gradient is taken at
PERTURB_SEED = 5
FLAGSHIP = "settings/pipeline/IceCube_3y_neutrinos.cfg"
TOY = "settings/pipeline/toy_fit_example.cfg"


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def flagship_config(grid_bins=None, fraction=None):
    """The flagship's config, its ``true_allsky_fine`` grid cut to
    `grid_bins` bins a side (as ``tests/test_torch_pipeline.py`` cuts it)
    and its events to `fraction` of each category."""
    from pisa_tpu_torch import ureg
    from pisa_tpu_torch.config.parser import parse_pipeline_config
    from pisa_tpu_torch.core import binning

    config = parse_pipeline_config(FLAGSHIP)
    if grid_bins is not None:
        grid = binning.MultiDimBinning([
            binning.OneDimBinning("true_energy", num_bins=grid_bins,
                                  is_log=True, domain=[1, 1000] * ureg.GeV),
            binning.OneDimBinning("true_coszen", num_bins=grid_bins,
                                  is_lin=True, domain=[-1, 1]),
        ], name="true_allsky_fine")
        for key, settings in config.items():
            if isinstance(key, tuple):
                for mode in ("calc_mode", "apply_mode"):
                    if getattr(settings.get(mode), "name", None) == grid.name:
                        settings[mode] = grid
    if fraction is not None:
        config[("data", "csv_loader")]["fraction_events_to_keep"] = fraction
    return config


def _perturbed(ct):
    v = np.clip(ct.current_rescaled_values(), 0.15, 0.85)
    rng = np.random.RandomState(PERTURB_SEED)
    return np.clip(v + rng.uniform(-0.1, 0.1, v.size), 0.15, 0.85)


def _maps(maps):
    return (np.stack([np.asarray(m.hist, dtype=np.float64) for m in maps]),
            np.stack([np.asarray(m.error_hist, dtype=np.float64)
                      for m in maps]))


def _template_case(out, tag, ct, data, v, capture=None):
    """The template at the current values and the mod_chi2 value and
    gradient at `v`, under `tag`."""
    import torch

    hist, err = _maps(ct.get_outputs())
    out[f"{tag}|hist"], out[f"{tag}|errors"] = hist, err
    out[f"{tag}|totals"] = ct.scan_totals(
        np.stack([ct.current_rescaled_values(), v])).cpu().numpy()
    _, vg = ct.build_objective(data, "mod_chi2", capture=capture)
    value, grad = vg(v)
    if ct.device.type == "cuda":
        torch.cuda.synchronize(ct.device)
    out[f"{tag}|value"] = float(value)
    out[f"{tag}|grad"] = grad.detach().cpu().numpy().astype(np.float64)


def toy(spec, out):
    from pisa_tpu_torch.core.pipeline import Pipeline
    from pisa_tpu_torch.parallel import default_mesh

    device = spec["device"]
    mesh = default_mesh(2, device=spec["device"])
    if mesh.rank is None:
        return
    pipeline = Pipeline(TOY, device=device)
    ct = pipeline.compile(capture=False)
    out["toy|free"] = np.asarray(ct.free_names)
    v = ct.current_rescaled_values()
    out["toy|v"] = v
    out["toy|unsharded"] = _maps(ct.get_outputs(v))[0]
    sharded = pipeline.compile(capture=False).shard(mesh)
    out["toy|stacked"] = sharded.stacked
    out["toy|sharded"] = _maps(sharded.get_outputs(v))[0]
    data = ct.get_outputs(v)
    perturbed = _perturbed(ct)
    for tag, template in (("toy|unsharded", ct), ("toy|sharded", sharded)):
        _, vg = template.build_objective(data, "mod_chi2", capture=False)
        value, grad = vg(perturbed)
        out[f"{tag}|value"] = float(value)
        out[f"{tag}|grad"] = grad.numpy()


def flagship(spec, out):
    import torch.distributed as dist

    from pisa_tpu_torch.core.pipeline import Pipeline
    from pisa_tpu_torch.parallel import default_mesh

    device = spec["device"]
    pipeline = Pipeline(flagship_config(spec["grid_bins"], spec["fraction"]),
                        device=device)
    eager_before = _maps(pipeline.get_outputs())
    ct = pipeline.compile(capture=False)
    out["flagship|free"] = np.asarray(ct.free_names)
    out["flagship|n_pad"] = ct._trace_data.containers[0].n_pad
    v = _perturbed(ct)
    out["flagship|v"] = v
    data = ct.get_outputs()
    _template_case(out, "flagship|unsharded", ct, data, v, capture=False)
    world = dist.get_world_size()
    meshes = [("grid2", default_mesh(2, device=device), 1, True),
              (f"world{world}", default_mesh(device=device), None, True),
              (f"percontainer{world}", default_mesh(device=device), None,
               False)]
    for tag, mesh, grid_min, stack in meshes:
        if mesh.rank is None:
            continue
        sharded = pipeline.compile(capture=False, stack=stack).shard(
            mesh, grid_min=grid_min)
        tag = f"flagship|{tag}"
        sc = sharded._trace_data.containers[0]
        out[f"{tag}|stacked"] = sharded.stacked
        out[f"{tag}|events"] = np.asarray(sc.shard.events)
        out[f"{tag}|n_events"] = sc.shard.n_events
        out[f"{tag}|grid"] = np.asarray(list(sc.shard.grids.values()))
        _template_case(out, tag, sharded, data, v, capture=False)
    eager_after = _maps(pipeline.get_outputs())
    out["flagship|eager_before"] = np.stack(eager_before)
    out["flagship|eager_after"] = np.stack(eager_after)


def multihost(spec, out):
    import torch

    from pisa_tpu_torch.core.collectives import all_reduce_sum
    from pisa_tpu_torch.ops.osc import chain
    from pisa_tpu_torch.ops.osc.pmns import dm_matrix, pmns_matrix
    from pisa_tpu_torch.parallel import default_mesh, multihost as mh

    mesh = default_mesh(2, device=spec["device"])
    try:
        mh.process_local_slice(63, mesh)
    except ValueError as exc:
        out["multihost|indivisible"] = str(exc)
    if mesh.rank is None:
        return
    rng = np.random.default_rng(7)
    n = 64
    energy = rng.uniform(1.0, 80.0, n)
    densities = rng.uniform(1.0, 10.0, (n, 3))
    distances = rng.uniform(100.0, 4000.0, (n, 3))
    e, d, x = (mh.make_global_array(a, mesh)
               for a in (energy, densities, distances))
    out["multihost|slice"] = np.asarray(mh.process_local_slice(n, mesh))
    out["multihost|block"] = np.asarray([e.start, e.local.shape[0]])
    dev = mesh.device
    f64 = torch.float64
    U = pmns_matrix(*(torch.tensor(v, dtype=f64, device=dev) for v in (
        np.sin(0.5839), np.sin(0.1496), np.sin(0.7854), 1.2)))
    dm = dm_matrix(torch.tensor(7.42e-5, dtype=f64, device=dev),
                   torch.tensor(2.514e-3, dtype=f64, device=dev))
    mat_pot = torch.diag(torch.tensor([1.0, 0.0, 0.0], dtype=torch.complex128,
                                      device=dev))
    pvec = chain.pack_from_physics(dm, U, mat_pot, torch.zeros(
        (3, 3), dtype=f64, device=dev), 1)
    nl = torch.full((e.local.shape[0],), 3, dtype=torch.int32, device=dev)
    probs = chain.chain_probs(pvec.to(f64), e.local.to(f64),
                              d.local.to(f64).T.contiguous(),
                              x.local.to(f64).T.contiguous(), nl)
    total = all_reduce_sum(probs[1, 1].sum(), mesh)
    out["multihost|value"] = float(total)


def batched(spec, out):
    import torch

    from pisa_tpu_torch.core.pipeline import Pipeline
    from pisa_tpu_torch.parallel import build_batched_objective, default_mesh

    mesh = default_mesh(2, device=spec["device"])
    if mesh.rank is None:
        return
    ct = Pipeline(TOY, device=spec["device"]).compile(capture=False)
    data = ct.get_outputs()
    objective = build_batched_objective(ct, data, "mod_chi2", mesh=mesh)
    value_only, _ = ct.build_objective(data, "mod_chi2")
    rng = np.random.RandomState(7)
    vecs = rng.uniform(0.2, 0.8, size=(8, len(ct.free_names)))
    out["batched|vecs"] = vecs
    out["batched|values"] = objective(vecs).numpy()
    out["batched|value_only"] = np.asarray(
        [float(value_only(vec)) for vec in vecs])
    out["batched|local"] = build_batched_objective(
        ct, data, "mod_chi2")(torch.as_tensor(vecs)).numpy()
    try:
        objective(vecs[:7])
    except ValueError as exc:
        out["batched|indivisible"] = str(exc)


def stale(spec, out):
    import torch.distributed as dist

    from pisa_tpu_torch.core.pipeline import Pipeline
    from pisa_tpu_torch.parallel import default_mesh

    mesh = default_mesh(device=spec["device"])
    ct = Pipeline(TOY, device=spec["device"]).compile(capture=False)
    data = ct.get_outputs()
    value_only, vg = ct.build_objective(data, "mod_chi2")
    v = _perturbed(ct)
    out["stale|before"] = float(value_only(v))
    ct.shard(mesh)
    for label, fn in (("value", value_only), ("vg", vg)):
        try:
            fn(v)
        except RuntimeError as exc:
            out[f"stale|{label}"] = str(exc)
    value_only, _ = ct.build_objective(data, "mod_chi2")
    out["stale|rebuilt"] = float(value_only(v))
    try:
        default_mesh(dist.get_world_size() + 1, device=spec["device"])
    except RuntimeError as exc:
        out["stale|too_many"] = str(exc)


def card_flagship(spec, out):
    """The full flagship on the card, sharded over the world with the grid
    split, eager; rank 0 also evaluates the unsharded template."""
    import torch

    from pisa_tpu_torch.core.pipeline import Pipeline
    from pisa_tpu_torch.ops.osc import chain
    from pisa_tpu_torch.parallel import default_mesh

    device = spec["device"]
    mesh = default_mesh(device=device)
    t0 = time.perf_counter()
    pipeline = Pipeline(flagship_config(spec["grid_bins"], spec["fraction"]),
                        device=device)
    out["card|setup_s"] = time.perf_counter() - t0
    ct = pipeline.compile(capture=False)
    v = _perturbed(ct)
    data = ct.get_outputs()
    if mesh.rank == 0:
        _template_case(out, "card|unsharded", ct, data, v, capture=False)
    sharded = pipeline.compile(capture=False).shard(mesh)
    sc = sharded._trace_data.containers[0]
    grid = list(sc.shard.grids.values())
    out["card|grid"] = np.asarray(grid)
    out["card|events"] = np.asarray(sc.shard.events)
    geom = pipeline.stages[[s.stage_name for s in pipeline.stages].index(
        "osc")]._grid_geometry(sc)
    out["card|points"] = int(geom["e"].shape[0])
    out["card|layer_steps"] = int(geom["nl"].sum())
    counts = (chain.launch_count, chain.multitangent_launch_count)
    _template_case(out, "card|sharded", sharded, data, v, capture=False)
    out["card|launches"] = np.asarray(
        [chain.launch_count - counts[0],
         chain.multitangent_launch_count - counts[1]])
    torch.cuda.synchronize(device)


CASES = {f.__name__: f for f in (toy, flagship, multihost, batched, stale,
                                 card_flagship)}


def run_rank(spec, world, rank, address, path):
    """Join the world, run the spec's cases, write the results to `path`."""
    import torch
    import torch.distributed as dist

    from pisa_tpu_torch.parallel import multihost as mh

    torch.set_num_threads(spec.get("threads", 1))
    out = {}
    t0 = time.perf_counter()
    mh.init_multihost(address, world, rank, device=spec["device"],
                      backend=spec.get("backend", "gloo"))
    out["init_s"] = time.perf_counter() - t0
    try:
        for name in spec["cases"]:
            t0 = time.perf_counter()
            try:
                CASES[name](spec, out)
            except Exception:  # recorded for the caller, which fails on it
                out[f"{name}|error"] = traceback.format_exc()
            out[f"{name}|seconds"] = time.perf_counter() - t0
            dist.barrier()
    finally:
        with open(path, "wb") as f:
            pickle.dump(out, f)
        dist.destroy_process_group()


class World:
    """The ranks of one world, started by :func:`start_world`."""

    def __init__(self, procs, paths, logs, directory):
        self._procs, self._paths, self._logs = procs, paths, logs
        self._dir = directory

    def results(self, timeout=600):
        """Each rank's results, in rank order, once all have ended; raises
        with the ranks' output if one failed or ran out of time."""
        deadline = time.monotonic() + timeout
        failed = []
        for rank, proc in enumerate(self._procs):
            try:
                proc.wait(max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            if proc.returncode != 0:
                failed.append(rank)
        logs = []
        for rank, log in enumerate(self._logs):
            log.seek(0)
            logs.append(f"-- rank {rank} --\n{log.read()[-6000:]}")
            log.close()
        if failed:
            self._dir.cleanup()
            raise RuntimeError(f"ranks {failed} failed:\n" + "\n".join(logs))
        results = []
        for path in self._paths:
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        self._dir.cleanup()
        return results


def start_world(spec, world, env=None):
    """Start `world` ranks on this host, each running `spec` (a dict, see
    the module docstring), rendezvous at a free port of 127.0.0.1; returns
    the :class:`World`, whose :meth:`World.results` waits for them."""
    directory = tempfile.TemporaryDirectory(prefix="sharded_world_")
    spec_path = os.path.join(directory.name, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    address = f"127.0.0.1:{free_port()}"
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs, paths, logs = [], [], []
    for rank in range(world):
        path = os.path.join(directory.name, f"rank{rank}.pkl")
        log = tempfile.TemporaryFile(mode="w+")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "pisa_tpu_torch.testing.sharded_worker",
             spec_path, str(world), str(rank), address, path],
            cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT,
            text=True))
        paths.append(path)
        logs.append(log)
    return World(procs, paths, logs, directory)


if __name__ == "__main__":
    spec_file, world, rank, address, path = sys.argv[1:6]
    with open(spec_file) as f:
        run_rank(json.load(f), int(world), int(rank), address, path)
