"""
Service smoke-matrix harness (counterpart of
``pisa_tpu/testing/service_matrix.py``; reference
``pisa_tests/test_services.py``): synthetic container sets, per-service
``init_test`` instantiation, set-up, compute and apply in the supported
modes, and the markdown support matrix.

The synthetic containers are the JAX harness's, value for value, for the
same seed (``numpy.random.RandomState``), so that both packages' services
can be held against each other on them. Containers are made on `device`
(the port's entry points default to the card; pass ``device="cpu"`` on a
machine without one).
"""

from __future__ import annotations

import importlib
import pkgutil

import numpy as np

from pisa_tpu_torch import FTYPE, ureg
from pisa_tpu_torch.core.binning import MultiDimBinning, OneDimBinning
from pisa_tpu_torch.core.container import Container, ContainerSet

import pisa_tpu_torch.stages

__all__ = [
    "TEST_BINNING",
    "SOURCE_SERVICES",
    "MAP_MODE_SERVICES",
    "key_value",
    "make_events_data",
    "make_map_data",
    "prepare_service",
    "discover_services",
    "run_service",
    "generate_matrix",
    "format_markdown_matrix",
]

N_EVTS = 40

TEST_BINNING = MultiDimBinning(
    [
        OneDimBinning(
            "true_energy", num_bins=5, is_log=True, domain=[1, 100] * ureg.GeV
        ),
        OneDimBinning("true_coszen", num_bins=4, is_lin=True, domain=[-1, 1]),
    ],
    name="test_binning",
)

#: services whose data is produced by the service itself (sources)
SOURCE_SERVICES = {
    "toy_event_generator", "grid", "csv_loader", "csv_data_hist",
    "csv_icc_hist", "simple_data_loader", "sqlite_loader", "meows_loader",
}

#: services that support a binned calc_mode (map mode, linked containers)
MAP_MODE_SERVICES = [
    ("flux", "barr_simple"),
    ("flux", "honda_ip"),
    ("flux", "mceq_barr"),
    ("flux", "mceq_barr_red"),
    ("osc", "prob3"),
    ("osc", "two_nu_osc"),
    ("osc", "decoherence"),
    ("osc", "external"),
    ("osc", "nusquids"),
    ("osc", "globes"),
    ("absorption", "earth_absorption"),
]

_ALL_FLAV_NAMES = (
    "nue_cc", "numu_cc", "nutau_cc", "nue_nc", "numu_nc", "nutau_nc",
    "nuebar_cc", "numubar_cc", "nutaubar_cc", "nuebar_nc", "numubar_nc",
    "nutaubar_nc",
)


def key_value(key, rng, n):
    """Synthetic value for a named container key (the JAX harness's)."""
    if key == "true_energy":
        return 10 ** rng.uniform(0.1, 1.9, n).astype(FTYPE)
    if key in ("true_coszen", "reco_coszen"):
        return rng.uniform(-1, 1, n).astype(FTYPE)
    if key == "reco_energy":
        return 10 ** rng.uniform(0.8, 1.9, n).astype(FTYPE)
    if key == "pid":
        return rng.choice([0.0, 1.0], n).astype(FTYPE)
    if key in ("weights", "initial_weights", "weighted_aeff"):
        return np.ones(n, dtype=FTYPE)
    if key in ("nu_flux", "nu_flux_nominal", "nubar_flux_nominal"):
        return np.ones((n, 2), dtype=FTYPE)
    if key == "errors":
        return np.full(n, 0.1, dtype=FTYPE)
    if key == "bjorken_y":
        return rng.uniform(0.1, 0.9, n).astype(FTYPE)
    if key == "dis":
        return rng.choice([0.0, 1.0], n).astype(FTYPE)
    if key in ("mHNL", "hnl_proper_lifetime", "hnl_decay_width"):
        return rng.uniform(0.5, 1.5, n).astype(FTYPE)
    if key == "hnl_true_energy":
        return 10 ** rng.uniform(0.1, 1.9, n).astype(FTYPE)
    if key == "hnl_distance_min":
        return np.full(n, 10.0, dtype=FTYPE)
    if key == "hnl_distance_max":
        return np.full(n, 100.0, dtype=FTYPE)
    if key == "bin_indices":
        return rng.randint(0, TEST_BINNING.size, n).astype(np.int32)
    if key.startswith(("linear_fit_", "quad_fit_")):
        return rng.uniform(-0.1, 0.1, n).astype(FTYPE)
    return rng.uniform(0.1, 1.0, n).astype(FTYPE)


def make_events_data(service, rng, device="cuda", n_events=N_EVTS):
    """Two-container events-mode ContainerSet providing the service's
    expected keys, `n_events` events each (the JAX harness's
    :data:`N_EVTS` by default)."""
    containers = []
    for name, nubar, flav in (("nutau_cc", 1, 2), ("numubar_nc", -1, 1)):
        c = Container(name, representation="events", device=device)
        c.set_aux_data("nubar", nubar)
        c.set_aux_data("flav", flav)
        for key in service.expected_container_keys:
            if key in c:
                continue
            c[key] = key_value(key, rng, n_events)
        extra = ["true_energy", "true_coszen", "weights"]
        for mode in (service.calc_mode, service.apply_mode):
            if isinstance(mode, MultiDimBinning):
                extra.extend(mode.names)
        for key in extra:
            if key not in c:
                c[key] = key_value(key, rng, n_events)
        containers.append(c)
    cs = ContainerSet("test", device=device, containers=containers)
    cs["output_binning"] = TEST_BINNING
    return cs


def make_map_data(service, rng, device="cuda"):
    """Full 12-flavour binned ContainerSet (map mode, linking paths)."""
    containers = []
    for name in _ALL_FLAV_NAMES:
        c = Container(name, representation=TEST_BINNING, device=device)
        nubar = -1 if "bar" in name else 1
        flav = {"e": 0, "mu": 1, "tau": 2}[
            name.replace("bar", "").split("_")[0][2:]
        ]
        c.set_aux_data("nubar", nubar)
        c.set_aux_data("flav", flav)
        for key in service.expected_container_keys:
            if key in c or key in TEST_BINNING.names:
                continue
            c[key] = key_value(key, rng, TEST_BINNING.size)
        if "weights" not in c and "weights" not in TEST_BINNING.names:
            c["weights"] = key_value("weights", rng, TEST_BINNING.size)
        containers.append(c)
    cs = ContainerSet("test", device=device, containers=containers)
    cs["output_binning"] = TEST_BINNING
    return cs


def discover_services():
    """[(stage, service)] for every module under pisa_tpu_torch.stages."""
    services = []
    for cat in pkgutil.iter_modules(pisa_tpu_torch.stages.__path__):
        if not cat.ispkg:
            continue
        pkg = importlib.import_module(f"pisa_tpu_torch.stages.{cat.name}")
        for mod in pkgutil.iter_modules(pkg.__path__):
            services.append((cat.name, mod.name))
    return services


def prepare_service(stage_name, service_name, mode="events", seed=42,
                    device="cuda"):
    """The service of `init_test` with its synthetic data attached (not set
    up): in `mode` "events" (a source service gets an empty set) or "map"
    (calc_mode = :data:`TEST_BINNING`, the 12 flavours binned); the data
    drawn from ``RandomState(seed)``, as the JAX harness draws it."""
    module = importlib.import_module(
        f"pisa_tpu_torch.stages.{stage_name}.{service_name}")
    rng = np.random.RandomState(seed)
    service = module.init_test()
    if mode == "map":
        service.calc_mode = TEST_BINNING
        data = make_map_data(service, rng, device=device)
    elif service_name in SOURCE_SERVICES:
        data = ContainerSet("test", device=device)
        data["output_binning"] = TEST_BINNING
    else:
        data = make_events_data(service, rng, device=device)
    service.data = data
    return service


def run_service(stage_name, service_name, mode="events", device="cuda"):
    """Instantiate, set up and run one service; returns a status string:
    'ok', 'no init_test', 'n/a' (no map mode), 'skip: <reason>' (a gated
    optional dependency), or 'FAIL: <error>'."""
    try:
        module = importlib.import_module(
            f"pisa_tpu_torch.stages.{stage_name}.{service_name}")
    except ImportError as exc:
        return f"skip: {exc}"
    if not hasattr(module, "init_test"):
        return "no init_test"
    if mode == "map" and (stage_name, service_name) not in MAP_MODE_SERVICES:
        return "n/a"
    try:
        service = prepare_service(stage_name, service_name, mode,
                                  device=device)
        service.setup()
        service.run()
        for c in service.data:
            if "weights" in c.keys and not bool(
                    c["weights"].isfinite().all()):
                return "FAIL: non-finite weights"
        return "ok"
    except (ImportError, FileNotFoundError) as exc:
        return f"skip: {exc}"
    except Exception as exc:  # noqa: BLE001 - the matrix reports, never raises
        return f"FAIL: {type(exc).__name__}: {exc}"
    except BaseException as exc:  # pytest.importorskip raises Skipped
        if type(exc).__name__ in ("Skipped", "XFailed"):
            return f"skip: {exc}"
        raise


def generate_matrix(verbose=False, device="cuda"):
    """[(stage, service, events_status, map_status)] for every service."""
    rows = []
    for stage_name, service_name in sorted(discover_services()):
        ev = run_service(stage_name, service_name, "events", device=device)
        mp = run_service(stage_name, service_name, "map", device=device)
        rows.append((stage_name, service_name, ev, mp))
        if verbose:
            print(f"{stage_name}.{service_name}: events={ev} map={mp}")
    return rows


def format_markdown_matrix(rows):
    """Markdown support matrix (reference
    ``test_services.generate_markdown_matrix:500``)."""
    def cell(status):
        if status == "ok":
            return "✓"
        if status == "n/a":
            return "—"
        if status.startswith("skip"):
            return "gated"
        if status == "no init_test":
            return "no test hook"
        return "✗ " + status[:60]

    lines = [
        "| service | events mode | map mode |",
        "|---|---|---|",
    ]
    for stage, service, ev, mp in rows:
        lines.append(f"| {stage}.{service} | {cell(ev)} | {cell(mp)} |")
    return "\n".join(lines)
