"""
Three-flavour matter-oscillation service (counterpart of
``pisa_tpu/stages/osc/prob3.py``; reference ``pisa/stages/osc/prob3.py:37``):
computes P(nu_e -> flav) and P(nu_mu -> flav) per grid point or per event
through Earth-layer chains and applies
``weights *= flux_e * P_e + flux_mu * P_mu``.

Options as in the reference: the NLO CC potential, NSI ('standard' /
'vacuum-like'), the reparameterized mixing matrix, neutrino decay, Earth
tomography, LRI, layer dedup, and the per-event calc mode. Each propagation
takes one of three routes, as the JAX package routes them (its
``prob3.py:437-446``):

- standard physics: ``ops/osc/chain.py:osc_probs``, one launch of the CUDA
  primal kernel per nubar sign, differentiable in the six oscillation
  parameters: when a compiled template takes the gradient, its backward
  runs the multitangent kernel once per sign (the flagship frees theta13,
  theta23 and deltam31: 3 tangents a launch), or, with
  ``multitangent=False``, the tangent kernel once per free oscillation
  parameter and sign (the multitangent route takes less device time on the
  card, ``PERF.md``);
- NSI and LRI: ``chain.py:osc_probs_general``, the same primal kernel on a
  general pack (a complex matter potential, an LRI term), differentiable in
  every coupling through the general formulation's reverse mode;
- neutrino decay and layer dedup: ``ops/osc/kernels.py:propagate_layers``
  alone, which no kernel computes (nor does the JAX package's Pallas path,
  its ``kernels.py:607-618``).

The layer geometry of each route (chain-length sort, per-point bounds,
layer-major slabs and tile table; or the compacted slot indices; or the
deduplicated chains) is prepared once at set-up, and again only when the
electron fractions or the tomography scalings change; the tomography scale
params therefore steer host-side work and cannot be free in a compiled
template (``core/template.py:HOST_PARAM_NAMES``).

On a binned calc grid the layers are flavour-independent and computed once;
on a category-stacked container (``core/stacking.py``) the compute is two
propagations, one per nubar sign; the probabilities become 6 rows (nubar
group x final flavour) that a rows map spreads over the categories, and the
apply forms one (6, ngrid) flux x probability rate on the grid. That rate is
gathered to the stacked events in one op, or, when the template that owns
the container set up rate deferral (``container.rate_defer``), handed to
the histogram stage as a grid-level factor (``container.deferred_rate``).

With ``calc_mode = events`` each container's events get their own chains; on
a stacked container each nubar group's (categories x padded events) block is
one propagation with its sign, over geometry prepared at set-up with the
padded slots sanitized on their inputs (energy 1 GeV, zero-length chains),
so that their values and gradients stay finite.

On a sharded template (``parallel/sharding.py``) a container holds one
rank's slice of the events, and, where the calc grid is split, of the
grid's flat points: the stage then propagates only that slice, over chain
geometry it builds for it (:meth:`prob3._grid_geometry`), the port's form of
the JAX package's ``grid_sharded`` switch (its ``prob3.py:580-586``); the
per-event geometries are built for the rank's events. Nothing here holds a
global index.

In an evaluation of lanes (``container.lanes``, the batched fits, the MCMC
walkers) every route takes its inputs with a leading lane axis: theta as a
(B, 6) tensor, and the general and layers routes' matrices as (B, 3, 3)
ones; every output gains the lane axis. The kernels launch as often as for
one point, each launch serving all lanes; the layers route builds each
lane's transitions in one batch. The per-event calc mode carries the lane
axis through its groups' blocks. In forward mode (``torch.func.jacfwd``,
the Fisher matrices) the standard route's tangents come from the
multitangent kernel (``chain.py:OscProbs``), the general route's from the
tangent and multitangent kernels at general packs
(``chain.py:OscProbsGeneral``), and the layers route's from forward mode
through the general formulation.
"""

from __future__ import annotations

import numpy as np
import torch

from pisa_tpu_torch import TORCH_FTYPE, ureg
from pisa_tpu_torch.core.binning import MultiDimBinning
from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage
from pisa_tpu_torch.ops.osc.chain import (
    osc_probs,
    osc_probs_general,
    prepare_chain_geometry,
    theta_tensor,
)
from pisa_tpu_torch.ops.osc.kernels import check_slot_index, propagate_layers
from pisa_tpu_torch.ops.osc.layers import Layers, dedup_layers, layer_slot_index
from pisa_tpu_torch.ops.osc.nonstandard import (
    FIVE_LAYER_RADII_KM,
    FIVE_LAYER_RHOS,
    TOMOGRAPHY_ERROR_MSG,
    Core_scaling_w_constrain,
    Core_scaling_wo_constrain,
    Mass_scaling,
    decay_matrix,
    lri_potential,
    std_nsi_eps,
    vacuum_nsi_eps,
)
from pisa_tpu_torch.ops.osc.pmns import dm_matrix, pmns_matrix, pmns_matrix_reparam

__all__ = ["prob3", "init_test", "LRI_TYPES", "NSI_TYPES", "TOMOGRAPHY_TYPES"]

LRI_TYPES = ["emu-symmetry", "etau-symmetry", "mutau-symmetry"]
NSI_TYPES = ["standard", "vacuum-like"]
TOMOGRAPHY_TYPES = [
    "mass_of_earth",
    "mass_of_core_w_constrain",
    "mass_of_core_wo_constrain",
]
_NSI_PARAMS = {
    "vacuum-like": (("eps_scale", "dimensionless"),
                    ("eps_prime", "dimensionless"), ("phi12", "rad"),
                    ("phi13", "rad"), ("phi23", "rad"), ("alpha1", "rad"),
                    ("alpha2", "rad"), ("deltansi", "rad")),
    "standard": (("eps_ee", "dimensionless"),
                 ("eps_emu_magn", "dimensionless"), ("eps_emu_phase", "rad"),
                 ("eps_etau_magn", "dimensionless"), ("eps_etau_phase", "rad"),
                 ("eps_mumu", "dimensionless"),
                 ("eps_mutau_magn", "dimensionless"),
                 ("eps_mutau_phase", "rad"), ("eps_tautau", "dimensionless")),
}
_TOMOGRAPHY_PARAMS = {
    "mass_of_earth": ("density_scale",),
    "mass_of_core_w_constrain": ("core_density_scale",),
    "mass_of_core_wo_constrain": ("core_density_scale",
                                  "innermantle_density_scale",
                                  "middlemantle_density_scale"),
}

_ALL_FLAVS = [
    "nue_cc", "numu_cc", "nutau_cc", "nue_nc", "numu_nc", "nutau_nc",
    "nuebar_cc", "numubar_cc", "nutaubar_cc", "nuebar_nc", "numubar_nc",
    "nutaubar_nc",
]
_NU_FLAVS = _ALL_FLAVS[:6]
_NUBAR_FLAVS = _ALL_FLAVS[6:]


def _choice(value, choices, option):
    if value is None:
        return None
    value = value.strip().lower()
    if value not in choices:
        raise ValueError(f"{option} {value!r} invalid; choose from {choices}")
    return value


class prob3(Stage):  # noqa: N801
    """See module docstring; parameters as in the reference
    (``prob3.py:124-161``), plus `multitangent` (the standard route's
    gradient tangents in one multitangent launch per sign, the default, or
    in one tangent launch per free oscillation parameter and sign; settable
    on the instance)."""

    # the Earth model, electron fractions and tomography scalings shape the
    # layer geometry, which is prepared on the host
    host_param_names = (
        "earth_model", "detector_depth", "prop_height", "YeI", "YeO", "YeM",
        "density_scale", "core_density_scale", "innermantle_density_scale",
        "middlemantle_density_scale",
    )
    _THETA_NAMES = (
        "theta12", "theta13", "theta23", "deltacp", "deltam21", "deltam31",
    )
    _THETA_UNITS = ("rad", "rad", "rad", "rad", "eV**2", "eV**2")

    def __init__(
        self,
        include_nlo=False,
        nsi_type=None,
        reparam_mix_matrix=False,
        neutrino_decay=False,
        tomography_type=None,
        lri_type=None,
        layer_dedup=False,
        multitangent=True,
        **std_kwargs,
    ):
        self.include_nlo = include_nlo
        self.nsi_type = _choice(nsi_type, NSI_TYPES, "nsi_type")
        self.reparam_mix_matrix = reparam_mix_matrix
        self.neutrino_decay = bool(neutrino_decay)
        self.lri_type = _choice(lri_type, LRI_TYPES, "lri_type")
        self.tomography_type = _choice(tomography_type, TOMOGRAPHY_TYPES,
                                       "tomography_type")
        self.layer_dedup = bool(layer_dedup)
        self.multitangent = bool(multitangent)
        expected = [
            "detector_depth", "earth_model", "prop_height", "YeI", "YeO",
            "YeM", "theta12", "theta13", "theta23", "deltam21", "deltam31",
            "deltacp",
        ]
        if self.nsi_type is not None:
            expected += [name for name, _ in _NSI_PARAMS[self.nsi_type]]
        if self.neutrino_decay:
            expected.append("decay_alpha3")
        if self.lri_type is not None:
            expected.append("v_lri")
        if self.tomography_type is not None:
            expected += _TOMOGRAPHY_PARAMS[self.tomography_type]
        super().__init__(
            expected_params=tuple(expected),
            expected_container_keys=(
                "true_energy", "true_coszen", "nubar", "flav", "nu_flux",
                "weights",
            ),
            **std_kwargs,
        )
        if self.neutrino_decay or self.layer_dedup:
            self.route = "layers"
        elif self.nsi_type is not None or self.lri_type is not None:
            self.route = "general"
        else:
            self.route = "standard"
        self.layers = None
        self.tomography_params = None
        #: the layer state the geometry was prepared for
        self._layer_state = None
        #: the calc grid's geometry (binned calc mode)
        self.geom = None
        #: per-event calc mode: per container name, (layer state, geometry);
        #: per stacked container (name, categories, padded size), the
        #: nubar groups' geometries (:meth:`_stacked_events_geometry`); on a
        #: sharded template each key also names the rank's slice, and a
        #: split calc grid's slices have theirs (:meth:`_grid_geometry`)
        self.geoms = {}

    # -- setup ---------------------------------------------------------------
    def setup_function(self):
        self.layers = Layers(
            self.params.earth_model.value,
            self.params.detector_depth.m_as("km"),
            self.params.prop_height.m_as("km"),
        )
        if self.tomography_type == "mass_of_earth":
            self.tomography_params = Mass_scaling()
        elif self.tomography_type is not None:
            radii_ext = self.layers.radii[::-1][:-1]
            rhos_ext = self.layers.rhos_unweighted[::-1][:-1]
            if not (
                len(radii_ext) == len(FIVE_LAYER_RADII_KM)
                and np.allclose(radii_ext, FIVE_LAYER_RADII_KM)
                and np.allclose(rhos_ext, FIVE_LAYER_RHOS)
            ):
                raise ValueError(TOMOGRAPHY_ERROR_MSG)
            if self.tomography_type == "mass_of_core_w_constrain":
                self.tomography_params = Core_scaling_w_constrain()
            else:
                self.tomography_params = Core_scaling_wo_constrain()
        self._layer_state = None
        self._update_layers()

    def _current_layer_state(self):
        ye = tuple(self.params[n].m_as("dimensionless")
                   for n in ("YeI", "YeO", "YeM"))
        scales = tuple(
            self.params[n].m_as("dimensionless")
            for n in _TOMOGRAPHY_PARAMS.get(self.tomography_type, ()))
        return ye, scales

    def _update_layers(self):
        """Re-derive the layers and every geometry where the electron
        fractions or the tomography scalings changed (the JAX package
        re-derives them at every compute with tomography on)."""
        state = self._current_layer_state()
        if state == self._layer_state:
            return
        ye, scales = state
        if self.tomography_type == "mass_of_earth":
            self.tomography_params.density_scale = scales[0]
            self.layers.scaling(self.tomography_params.density_scale)
        elif self.tomography_type == "mass_of_core_w_constrain":
            self.tomography_params.core_density_scale = scales[0]
            self.layers.scaling(self.tomography_params.scaling_array)
        elif self.tomography_type is not None:
            tp = self.tomography_params
            (tp.core_density_scale, tp.innermantle_density_scale,
             tp.middlemantle_density_scale) = scales
            self.layers.scaling(tp.scaling_factor_array)
        self.layers.setElecFrac(*ye)
        self._layer_state = state
        self._prepare_geometry()

    def _chains(self, coszen):
        """(densities, distances) of the layer chains at `coszen`, (N, L)."""
        self.layers.calcLayers(np.asarray(coszen, dtype=np.float64))
        shape = (len(coszen), self.layers.max_layers)
        return (self.layers.density.reshape(shape),
                self.layers.distance.reshape(shape))

    def _make_geometry(self, energy, densities, distances):
        """The route's static inputs for one propagation over these points:
        the kernels' prepared geometry (standard and general routes), or
        the general formulation's chains with their slot indices (or, with
        layer dedup, their unique slots and chain map)."""
        device = self.data.device
        if self.route != "layers":
            return prepare_chain_geometry(energy, densities, distances,
                                          dtype=TORCH_FTYPE, device=device,
                                          general=self.route == "general")

        def put(x, dtype=TORCH_FTYPE):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                                   device=device)

        if self.layer_dedup:
            dens, dist, chain_map = dedup_layers(densities, distances)
            return {"e": put(energy), "dens": put(dens), "dist": put(dist),
                    "chain_map": put(chain_map, torch.int64)}
        geom = {"e": put(energy), "dens": put(densities),
                "dist": put(distances),
                "slot_index": put(layer_slot_index(distances), torch.int64)}
        # checked here, once, so that the propagation reads nothing back
        check_slot_index(geom["dist"], geom["slot_index"])
        return geom

    def _grid_points(self):
        """(energy, coszen) of the calc grid's flat points."""
        binning = self.calc_mode
        grid = binning.meshgrid(entity="weighted_centers", attach_units=False)
        return (grid[binning.index("true_energy")].ravel(),
                grid[binning.index("true_coszen")].ravel())

    def _grid_geometry(self, container):
        """The calc grid's geometry for `container`: the whole grid's, or,
        where a sharded template split the grid, that of the rank's slice of
        its flat points, built for the current layers."""
        shard = getattr(container, "shard", None)
        grid = None if shard is None else shard.grids.get(hash(self.calc_mode))
        if grid is None:
            return self.geom
        key = ("grid", tuple(grid))
        state, geom = self.geoms.get(key, (None, None))
        if state != self._layer_state:
            energy, coszen = (x[slice(*grid)] for x in self._grid_points())
            geom = self._make_geometry(energy, *self._chains(coszen))
            self.geoms[key] = (self._layer_state, geom)
        return geom

    @staticmethod
    def _shard_key(container):
        shard = getattr(container, "shard", None)
        return None if shard is None else shard.key

    def _prepare_geometry(self):
        """The geometry of every propagation, for the current layers: the
        calc grid's (its chains are flavour-independent: computed once), or
        each container's events'."""
        if self.is_map:
            energy, coszen = self._grid_points()
            self.geom = self._make_geometry(energy, *self._chains(coszen))
            return
        for container in self.data:
            if getattr(container, "is_stacked", False):
                self._stacked_events_geometry(container)
            else:
                self._events_geometry(container)

    def _events_geometry(self, container):
        """One container's per-event geometry, for the current layers."""
        key = (container.name, self._shard_key(container))
        state, geom = self.geoms.get(key, (None, None))
        if state != self._layer_state:
            energy = container["true_energy"].detach().cpu().numpy()
            coszen = container["true_coszen"].detach().cpu().numpy()
            geom = self._make_geometry(energy, *self._chains(coszen))
            self.geoms[key] = (self._layer_state, geom)
        return geom

    def _stacked_events_geometry(self, container):
        """Per nubar group, one geometry over the group's (categories x
        padded events) block, flattened; padded slots get energy 1 GeV and
        zero-length chains (their inputs sanitized, so that values and
        gradients stay finite). Kept in ``self.geoms`` for the current
        layers, with the permutation that puts the groups' blocks back in
        category order and each category's final flavour."""
        key = (container.name, tuple(container.cat_names), container.n_pad,
               self._shard_key(container))
        static = self.geoms.get(key)
        if static is not None and static["state"] == self._layer_state:
            return static
        prev = container.representation
        container.representation = "events"
        try:
            energy = container["true_energy"].detach().cpu().numpy()
            coszen = container["true_coszen"].detach().cpu().numpy()
        finally:
            container.representation = prev
        pad = ~(np.isfinite(energy) & (energy > 0) & np.isfinite(coszen))
        energy = np.where(pad, 1.0, energy)
        coszen = np.where(pad, 1.0, coszen)
        grp = (np.asarray(container.cat_aux("nubar")) < 0).astype(np.int32)
        groups = []
        for sign in (1, -1):
            idx = np.flatnonzero(grp == (1 if sign < 0 else 0))
            if idx.size == 0:
                continue
            dens, dist = self._chains(coszen[idx].reshape(-1))
            keep = ~pad[idx].reshape(-1, 1)
            geom = self._make_geometry(energy[idx].reshape(-1),
                                       np.where(keep, dens, 0.0),
                                       np.where(keep, dist, 0.0))
            groups.append((sign, idx, geom))
        order = np.concatenate([idx for _, idx, _ in groups])
        device = self.data.device
        static = self.geoms[key] = {
            "state": self._layer_state,
            "groups": [(sign, geom) for sign, _, geom in groups],
            "inv": torch.as_tensor(np.argsort(order), device=device),
            "flav": torch.as_tensor(
                np.asarray(container.cat_aux("flav"), dtype=np.int64),
                device=device)[:, None, None],
        }
        return static

    # -- compute --------------------------------------------------------------
    def _physics(self):
        """The propagation's inputs from the params, on the data's device;
        the magnitudes may be 0-d tensors that carry the autograd graph
        (compiled template), or lanes of them. ``theta`` (6,) or (B, 6)
        float64 for every route; for the general and layers routes also the
        float64 (complex128) ``dm``, ``mix``, ``mat_pot``, ``mat_decay``
        and ``lri_pot``."""
        device = self.data.device
        prms = [self.params[name] for name in self._THETA_NAMES]
        theta = theta_tensor(
            [p.m_as(u) for p, u in zip(prms, self._THETA_UNITS)],
            device=device, lanes=self.data.lanes,
        )
        out = {"theta": theta,
               # tangents only for the free oscillation parameters
               "active": tuple(i for i, p in enumerate(prms) if not p.is_fixed)}
        if self.route == "standard":
            return out
        t12, t13, t23, dcp, dm21, dm31 = theta.unbind(-1)
        pmns = pmns_matrix_reparam if self.reparam_mix_matrix else pmns_matrix
        out["mix"] = pmns(torch.sin(t12), torch.sin(t13), torch.sin(t23), dcp)
        out["dm"] = dm_matrix(dm21, dm31)
        # the generalized matter potential: the standard CC term (with the
        # NLO factor; a constant, filled in on the device) plus the NSI
        # couplings, (3, 3) or (B, 3, 3) lanes
        mat_pot = torch.zeros((3, 3), dtype=torch.complex128, device=device)
        mat_pot[0, 0].fill_(1.020 if self.include_nlo else 1.0)
        if self.nsi_type is not None:
            build = (std_nsi_eps if self.nsi_type == "standard"
                     else vacuum_nsi_eps)
            mat_pot = mat_pot + build(
                *[self.params[n].m_as(u) for n, u in _NSI_PARAMS[self.nsi_type]],
                device=device)
        out["mat_pot"] = mat_pot
        out["mat_decay"] = (
            decay_matrix(self.params.decay_alpha3.m_as("eV**2"), device=device)
            if self.neutrino_decay else None)
        out["lri_pot"] = (
            lri_potential(self.params.v_lri.m_as("eV"), self.lri_type,
                          device=device)
            if self.lri_type is not None
            else torch.zeros((3, 3), dtype=torch.float64, device=device))
        return out

    def _propagate(self, geom, nubar, physics):
        """One propagation over `geom` with sign `nubar`: ([B,] N, 3, 3)."""
        if self.route == "standard":
            return osc_probs(
                physics["theta"], nubar, geom,
                reparam=self.reparam_mix_matrix,
                nlo_factor=1.020 if self.include_nlo else 1.0,
                active=physics["active"], multitangent=self.multitangent,
            )
        if self.route == "general":
            return osc_probs_general(physics["dm"], physics["mix"],
                                     physics["mat_pot"], physics["lri_pot"],
                                     nubar, geom)
        return propagate_layers(
            physics["dm"], physics["mix"], physics["mat_pot"],
            physics["mat_decay"], physics["lri_pot"], nubar, geom["e"],
            geom["dens"], geom["dist"], decay_flag=self.neutrino_decay,
            chain_map=geom.get("chain_map"), slot_index=geom.get("slot_index"))

    def compute_function(self):
        self._update_layers()

        # angles must carry units (reference prob3.py:480-482)
        for angle in (
            self.params.theta12,
            self.params.theta13,
            self.params.theta23,
            self.params.deltacp,
        ):
            if angle.value.units == ureg.dimensionless:
                raise ValueError(f"{angle.name} is dimensionless; give rad or deg")
        physics = self._physics()

        stacked = any(getattr(c, "is_stacked", False)
                      for c in self.data.containers)
        if stacked and not self.is_map:
            for container in self.data:
                self._compute_stacked_events(container, physics)
            return
        if stacked:
            # one propagation per nubar sign, as on the linked path, stacked
            # into 2 rows; the per-flavour projections become 6 rows (nubar
            # group x final flavour) that a rows map spreads over the
            # categories
            for container in self.data:
                grp = (np.asarray(container.cat_aux("nubar")) < 0).astype(
                    np.int32)
                flav = np.asarray(container.cat_aux("flav"), dtype=np.int32)
                geom = self._grid_geometry(container)
                probability = torch.stack(
                    [self._propagate(geom, sign, physics)
                     for sign in (1, -1)], dim=-4)  # ([B,] 2, n, 3, 3)
                container.set_stacked("probability", probability, rows=grp)
                # rows = group * 3 + final flavour: P(e -> f), P(mu -> f)
                lead = probability.shape[:-4]
                pe = probability[..., 0, :].transpose(-1, -2).reshape(
                    lead + (6, -1))
                pm = probability[..., 1, :].transpose(-1, -2).reshape(
                    lead + (6, -1))
                container.set_stacked("prob_e", pe, rows=grp * 3 + flav)
                container.set_stacked("prob_mu", pm, rows=grp * 3 + flav)
            return

        if self.is_map:
            self.data.link_containers("nu", _NU_FLAVS)
            self.data.link_containers("nubar", _NUBAR_FLAVS)
        for container in self.data:
            geom = (self.geom if self.is_map
                    else self._events_geometry(container))
            container["probability"] = self._propagate(
                geom, int(container["nubar"]), physics)
        self.data.unlink_containers()

        # per-flavour projections: P(e -> flav), P(mu -> flav)
        for container in self.data:
            flav = int(container["flav"])
            probs = container["probability"]
            container["prob_e"] = probs[..., 0, flav]
            container["prob_mu"] = probs[..., 1, flav]

    def _compute_stacked_events(self, container, physics):
        """Per-event calc on a stacked container (``_compute_stacked_events``
        :727 of the JAX package): one fixed-sign propagation per nubar group
        over its (categories x padded events) block, the blocks put back in
        category order as (C, n_pad, 3, 3), and each category's
        P(e -> flav), P(mu -> flav) as (C, n_pad); with lanes, (B, C, n_pad,
        3, 3) and (B, C, n_pad)."""
        static = self._stacked_events_geometry(container)
        n_pad = container.n_pad
        lead = physics["theta"].shape[:-1]
        k = len(lead)  # the categories' axis
        blocks = [self._propagate(geom, sign, physics).reshape(
            lead + (-1, n_pad, 3, 3)) for sign, geom in static["groups"]]
        probs = torch.cat(blocks, dim=k).index_select(k, static["inv"])
        container["probability"] = probs
        fl = static["flav"].expand(lead + (-1, n_pad, 1))
        container["prob_e"] = torch.gather(probs[..., 0, :], -1, fl)[..., 0]
        container["prob_mu"] = torch.gather(probs[..., 1, :], -1, fl)[..., 0]

    def stacked_ok(self):
        return (self.is_map or self.calc_mode == "events") and not isinstance(
            self.apply_mode, MultiDimBinning)

    supports_shard = True

    def prepare_stacked(self, data):
        for container in data.containers:
            if self.is_map:
                self._grid_geometry(container)
            else:
                self._stacked_events_geometry(container)

    def _apply_stacked(self, container):
        """The (6, ngrid) rate (nubar group x final flavour; the flux does
        not depend on the flavour, so each of its 2 rows serves 3 rate
        rows) formed on the grid, then gathered to the stacked events in one
        op or deferred to the histogram stage. With a per-event flux or
        per-event probabilities (the per-event calc mode) the grid identity
        does not hold: the product is taken per event, as on the unstacked
        unfused branch."""
        rep = container.representation
        calc_h = hash(self.calc_mode)
        k = 0 if container.lanes is None else 1  # the lane axis, if any
        valid = container.validity
        if isinstance(rep, str) and (
                valid.get("nu_flux", {}).get(hash(rep), False)
                or valid.get("prob_e", {}).get(hash(rep), False)):
            nu_flux = container["nu_flux"]  # (C, n_pad, 2) per event
            container["weights"] = container["weights"] * (
                nu_flux[..., 0] * container["prob_e"]
                + nu_flux[..., 1] * container["prob_mu"]
            )
            return
        container.representation = self.calc_mode
        nu_flux = container["nu_flux"]  # (2, n, 2), rows = nubar group
        rows_flux = container.rows[("nu_flux", calc_h)]
        pe = container["prob_e"]  # (6, n), rows = group * 3 + flavour
        pm = container["prob_mu"]
        rows_pf = container.rows[("prob_e", calc_h)]
        if nu_flux.dim() - k == 2:
            nf6 = nu_flux.unsqueeze(k)  # one flux shared by all categories
        elif (
            nu_flux.shape[k] == 2
            and isinstance(rows_flux, np.ndarray)
            and np.array_equal(rows_flux, np.asarray(rows_pf) // 3)
        ):
            # each flux group row for its 3 flavour rows
            nf6 = nu_flux.repeat_interleave(3, dim=k)
        else:
            raise NotImplementedError(
                "stacked prob3 expects a shared or nubar-grouped nu_flux on"
                f" the calc grid (got shape {tuple(nu_flux.shape)}, rows"
                f" {rows_flux!r})"
            )
        rate = nf6[..., 0] * pe + nf6[..., 1] * pm
        if container.rate_defer is not None:
            # the histogram stage contracts the grid rate with its static
            # (grid x bins) matrices (stages/utils/hist.py)
            container.deferred_rate = {"rate": rate, "rows": rows_pf}
            container.representation = rep
            return
        container.set_stacked("osc_flux_rate", rate, rows=rows_pf)
        container.representation = rep
        container["weights"] = (
            container["weights"] * container["osc_flux_rate"]
        )

    def apply_function(self):
        calc_h = hash(self.calc_mode)
        for container in self.data:
            if getattr(container, "is_stacked", False):
                self._apply_stacked(container)
                continue
            # When flux and probabilities are valid on the calc grid and the
            # apply representation is events, form the rate on the grid and
            # translate the one channel: the 'average' lookup gathers the
            # event's own grid cell, so gather(flux)*gather(prob) ==
            # gather(flux*prob) exactly. Not so for a binned apply (resample
            # averages) or an already per-event flux: the unfused branch.
            apply_rep = container.representation
            apply_h = hash(apply_rep)
            valid = container.validity
            fusable = (
                apply_h != calc_h
                and isinstance(apply_rep, str)
                and not valid.get("nu_flux", {}).get(apply_h, False)
                and valid.get("nu_flux", {}).get(calc_h, False)
                and valid.get("prob_e", {}).get(calc_h, False)
                and valid.get("prob_mu", {}).get(calc_h, False)
            )
            if fusable:
                container.representation = self.calc_mode
                nu_flux = container["nu_flux"]
                container["osc_flux_rate"] = (
                    nu_flux[..., 0] * container["prob_e"]
                    + nu_flux[..., 1] * container["prob_mu"]
                )
                container.representation = apply_rep
                container["weights"] = (
                    container["weights"] * container["osc_flux_rate"]
                )
            else:
                nu_flux = container["nu_flux"]
                container["weights"] = container["weights"] * (
                    nu_flux[..., 0] * container["prob_e"]
                    + nu_flux[..., 1] * container["prob_mu"]
                )


def init_test(**param_kwargs):
    """Instantiation example."""
    param_set = ParamSet(
        [
            Param(name="detector_depth", value=10 * ureg.km, **param_kwargs),
            Param(name="prop_height", value=18 * ureg.km, **param_kwargs),
            Param(
                name="earth_model", value="osc/PREM_4layer.dat", **param_kwargs
            ),
            Param(name="YeI", value=0.5, **param_kwargs),
            Param(name="YeO", value=0.5, **param_kwargs),
            Param(name="YeM", value=0.5, **param_kwargs),
            Param(name="theta12", value=33 * ureg.degree, **param_kwargs),
            Param(name="theta13", value=8 * ureg.degree, **param_kwargs),
            Param(name="theta23", value=50 * ureg.degree, **param_kwargs),
            Param(name="deltam21", value=8e-5 * ureg.eV**2, **param_kwargs),
            Param(name="deltam31", value=3e-3 * ureg.eV**2, **param_kwargs),
            Param(name="deltacp", value=180 * ureg.degree, **param_kwargs),
        ]
    )
    return prob3(include_nlo=True, params=param_set)
