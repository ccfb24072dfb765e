#!/usr/bin/env python3
"""
Smoke test of the PyTorch/CUDA port (``pisa_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's seven CUDA kernels (the oscillation chain, its
tangent and its multitangent, the 4x4 Hermitian eigenvalues of the 3+1
layer step, and the KDE's Gaussian sum, its vector-Jacobian product and
its Jacobian-vector product) from the
sources in the checkout, checks each against
its plain PyTorch version on the card at the flagship's shapes, and drives
the flagship IceCube 3-year pipeline
(``settings/pipeline/IceCube_3y_neutrinos.cfg``: 240k events, 200x200
oscillation grid, 15 free parameters) on the card through its two paths:

- the eager template, ``Pipeline(..., device="cuda").get_outputs()``, in
  float32 and float64, each template compared with the same pipeline run on
  the CPU in float64;
- the fit, ``Pipeline(...).compile().build_objective(data, "mod_chi2")``:
  by default the twelve categories stacked into one container and the whole
  ``value_and_grad`` captured in one CUDA graph. In float64 the stacked and
  captured template, value and gradient are held against the CPU's
  per-container run, with rate deferral on and off, and a replay against a
  fresh eager run (at two points and after a range change); the
  per-container eager ``value_and_grad`` stays checked against the CPU,
  against central finite differences, and with separate tangents against
  the multitangent. In float32: the same against float64, and the bounded
  L-BFGS Asimov fit (``analysis/device_fit.minimize_on_device``) on the
  captured objective;
- the captured template call, ``Pipeline(...).compile()(vec)`` and
  ``scan_totals``: in float64 a replay against a fresh eager run per bin
  (at two points and after a range change) and the scan against the calls;
  in float32 timed over 100 randomized vectors, the scan waiting once;
- the analysis layer, the slice's main path: ``DistributionMaker([cfg],
  device="cuda")``, Asimov data at nominal, theta23 moved by +0.10
  rescaled, and ``Analysis().fit_recursively`` with the methods ``device``
  and ``gradient`` and the octant strategy around ``device``, each timed
  with its iterations, evaluations and waits for the card (float32);
- the L-BFGS of ``analysis/device_fit.py`` on the card and on the CPU over
  the 20x20-grid flagship from the same start (float64): the same
  iterations and best fit;
- the batched fits: ``fit_batch_on_device`` with 4
  lanes on the 20x20-grid flagship that stop at different iterations,
  against each lane's solo fit on the card and against the same batch on
  the CPU (float64),
  and ``fit_pseudo_ensemble(cd, "llh", n_trials=64)`` on the flagship at
  full width (float32), with the batched ``value_and_grad`` timed at B = 1,
  16 and 64 (its launches, waits and peak memory) and one solo fit from the
  same start beside the ensemble;
- the IceCube 3-year data release's fit, this slice's main path:
  ``DistributionMaker([IceCube_3y_neutrinos_daemon.cfg,
  IceCube_3y_muons.cfg], device="cuda")`` (36 free parameters, the
  daemonflux flux per event, the neutrinos stacked and the muons per
  container, in one captured program) against the released counts of
  ``IceCube_3y_data.cfg``: the value_and_grad of mod_chi2 on the card
  against the CPU in float64, then in float32 against that, with its
  wall, waits, kernels, busy share and peak memory;
  ``Analysis().fit_recursively(data, hm, "mod_chi2", None, "device", {},
  None)`` and ``fit_pseudo_ensemble(cd, "mod_chi2", n_trials=64)`` beside
  one solo fit;
- the rest of the analysis layer: in float64 (a child process), card
  against CPU, the MC-uncertainty metrics (``mcllh_mean``, ``mcllh_eff``,
  ``barlow_llh``, ``conv_llh``, through ``CompiledDistribution`` with a
  nonzero data variance) and ``build_objective(sum_maps=True)`` on the
  20x20-grid flagship, the generalized likelihood's toy
  (``toy_generalized_llh.cfg``, n_events set through its param to 240,000:
  alphas, betas, value and gradient, k_max, the objective's and the
  recursion's times), and the Fisher matrix and pulls on the 20x20-grid
  flagship; in float32 at full width, each metric's captured
  value_and_grad timed, a ``device`` fit under mcllh_eff and two ``nlopt``
  fits through ``Analysis``, the Fisher matrix (``jacfwd``: its launches
  against the vmap rule's count, its Jacobian against central differences
  of the captured template, one jvp's tangent launches), and
  ``mcmc_sampling`` with 32 walkers (wall and host waits per step);
- prob3's physics options, this slice's main path: the three kernels held
  against their plain versions at general packs (NSI's complex
  off-diagonal matter term, LRI's), then in float64 (a child process), card
  against CPU, the value_and_grad of (a) NSI with eps_mutau_magn free and
  (b) decay with decay_alpha3 free on the 20x20-grid flagship and (c) the
  per-event calc mode at 5% of the events; then at full width in float32
  through the entry points: (a) ``nsi_type = standard`` with the 9 eps_*
  and eps_mutau_magn free (16 free params): the captured value_and_grad
  and a ``device`` fit through ``Analysis`` that recovers eps_mutau_magn
  and theta23; (b) ``neutrino_decay`` with decay_alpha3 free: the template
  and the captured value_and_grad, finite at float32; (c) prob3 and
  barr_simple at ``calc_mode = events``, stacked, at 240k events: the
  template and the captured value_and_grad; (d) LRI, the three tomography
  types and ``layer_dedup``: the template. Each value_and_grad with its
  wall, back-to-back time, kernels per replay, busy share, peak memory and
  launches;
- forward mode and lanes under the options, this slice's main path: the
  three kernels over 16 lanes of general packs (each lane its own theta,
  couplings and sign) against their plain versions and against each
  lane's single launch; in float64 (a child process), card against CPU on
  the 20x20-grid flagship, ``get_fisher_matrix`` under NSI and under LRI
  (emu), each with 16 free params (its launches: one primal and ceil(16 /
  6) multitangent launches per sign), and ``fit_batch_on_device`` with 4
  lanes under NSI, decay and the per-event calc mode against each lane's
  solo fit and the CPU; then at full width in float32 under NSI (16 free):
  ``get_fisher_matrix`` (wall, launches), ``mcmc_sampling`` with 32
  walkers (wall per step), and ``fit_pseudo_ensemble(cd, "mod_chi2",
  n_trials=16)`` (wall per trial, evaluations, peak memory, the launches of
  one 16-lane value_and_grad), and lane 0 beside its solo fit (the
  64-trial NSI ensemble was cut to keep the whole run in its time limit;
  ``OPTIONS_TRIALS`` runs it again where 64 is added);
- the remaining oscillation services, this slice's main path: the
  herm4_eig kernel (the 3+1 layer step's 4x4 Hermitian eigenvalues,
  ``csrc/herm4_eig.cu``) against its plain version at the 3+1 flagship's
  279,600 layer steps (nu and nubar, nominal and 3 seeded points, float64
  and float32), its float64 jvp and backward against central differences,
  its time beside the plain version's and one torch.linalg.eigvalsh call's;
  in float64 (a child process), card against CPU, sterile_example.cfg and
  the 20x20-grid 3+1 flagship in the low-pass and the amplitude pictures
  (maps and the captured value_and_grad), and 3-flavour nusquids against
  prob3 on the card; then the 3+1 flagship at full width in float32
  (``testing/sterile_flagship.py``, 17 free, per container): the template,
  the captured value_and_grad (no wait inside the replay), the Fisher
  matrix, a ``device`` fit through Analysis from theta24 moved off its
  truth, a 4-trial pseudo-ensemble with its per-lane peak memory; and the
  3-flavour nusquids flagship's template, value_and_grad and Fisher matrix
  on the chain kernels. It prints early whether ``h5py`` is installed;
- the HDF5 event path and the KDE stage, this slice's main path: the two
  KDE kernels (``csrc/kde_gauss.cu``) against their plain versions at the
  full-width shapes (24 category x PID channels of 20,000 samples, the
  pilot at the samples and the 1,320 points of kde_example's grid; float64
  and float32; a channel without weight; the float64 density's backward
  against central differences) with their times, bounds and registers; in
  float64 (a child process, ``h5py`` made unimportable), card against
  CPU, ``example``, ``fast_example``, ``varbin_example`` and
  ``kde_example.cfg`` from the repo's HDF5 file through the port's reader,
  kde_example's compiled value_and_grad, and the same path at 2,000 toy
  events per category; then in float32 ``kde_example.cfg`` fed
  ``make_toy_events`` (240,000 events): the eager and the stacked captured
  template, the captured value_and_grad (no wait inside the replay), its
  Fisher matrix (``jacfwd`` through the density's forward mode on
  ``kde_gauss_sum_jvp``, whose check beside the other KDE kernels'
  comes first; float64 card against CPU at 2,000 toy events per category
  in the child), a ``device`` fit through Analysis from theta23 moved by
  +0.10, and ``example.cfg`` at the same events;
- the MCEq-Barr flagship (``testing/mceq_flagship.py``: mceq_barr on
  honda_ip's flux, earth_absorption and nutau_xsec after prob3, 31 free
  parameters, per container): in float64 (a child process) card against
  CPU on a 20x20 grid, maps and the captured value_and_grad, and the
  cross-section services dis_sys, genie_sys and correct_charm_y at 240,000
  synthetic events; then in float32 at full width the template, the
  captured value_and_grad and a ``device`` fit through Analysis from
  theta23 + 0.10. The analysis child also holds the generalized
  likelihood's host C route (``use_c=True``) against the torch route;
- hypersurfaces fitted on the flagship and applied to it, this slice's
  main path: in float64 (a child process), card against CPU, the fit of
  the 13 datasets (delta_index linear, Barr_uphor_ratio quadratic,
  nu_nc_norm linear; a nominal and 12 systematic points, bench.py:656-671's
  design) combined into the hypersurfaces stage's four groups, the
  flagship with the fit applied (uncertainty propagated: maps, errors, the
  compiled value_and_grad), and the interpolated workflow over Delta
  m^2_31 at 5% of the events; then in float32 at full width:
  ``fit_hypersurfaces_from_pipeline``, the fit alone timed warm as
  bench.py times ``hypersurface_fit_wall_s`` (its kernels, its waits, none
  inside the Gauss-Newton loop, float32 against a float64 fit of the same
  inputs), the fit as JSON applied with its uncertainty (the eager and
  captured template, the captured value_and_grad, a ``device`` fit
  through Analysis from theta23 + 0.10), the interpolated workflow
  (prepare, one job, the resume, assemble) and its template between grid
  values, and ``discr_sys.csv_hypersurfaces`` from the grid's fits with
  Delta m^2_31 free in a captured value_and_grad;
- the parameterized-detector study (``testing/param_detector.py``: toy
  events, barr_simple, prob3 on the 200x200 calc grid, then aeff.param,
  reco.simple_param, reco.resolutions, hist to the 200 reco bins and
  fix_error; 4 free, per container), this slice's main path: in float64
  (a child process), card against CPU, its 12 maps and captured
  value_and_grad at 2,000 events a category on the coarse grid, its reco
  variables at 240,000 events exactly, and each of its 13 services and
  hist's options at 240,000 synthetic events (outputs and parameter
  gradients; the random streams exactly); then in float32 at full width
  (240,000 events) the eager template, the captured value_and_grad and a
  ``device`` fit through Analysis from theta23 + 0.10, and the
  multitangent kernel at K = 2 on the path's grid, timed;
- the command-line entry points and the llh server, this slice's main
  path (``cli_fp32``, float32, the flagship at full width): each command
  called through its ``main(argv)`` in this process. ``pipeline --compile
  --outdir`` writes the captured template, which ``compare`` holds against
  the CPU float64 nominal template (the reference child's) to the float32
  template bound (exit code 0); ``analysis --method device -o`` fits Asimov
  data at theta23 + 0.10 rescaled and the written state recovers theta23;
  ``python -m pisa_tpu_torch.utils.llh_server`` runs in a child process
  over the same data, and 16 requests of ``llh_client.Client`` match this
  process's own ``-value_only(x)`` (its first answer after its start and
  the median round trip timed); ``benchmark -n 50`` and ``--in-device -n
  100`` print templates/s;
- the events-file workflow on the port's own HDF5 writer, this slice's main
  path (``events_file_fp32``, float32): 240,000 simulated events (12
  flavour and interaction categories of 20,000) written as per-run source
  files with no ``h5py``, ``make_events_file`` (unjoined) and
  ``add_fluxes_to_file`` (the Honda table, flux name "nominal"), every
  array read back bit-equal to what the scripts held and the file
  byte-equal to the one a float64 child wrote beside the other children;
  ``example.cfg`` from the file on the card, its template within 3e-6 of
  that child's CPU float64 template in bins with >= 1 event and its
  captured value_and_grad; and the histogram scatter-added past the
  one-hot budget (640 bins, per container) over 4 lanes against 4 unlaned
  evaluations, and toy_fit_example's probabilities resampled from a
  200 x 200 grid over 4 lanes against 4 unlaned evaluations. It prints each
  write and read time, the three bins farthest from the float64 template,
  and its wall;
- multi-device evaluation, this slice's main path (``sharded_fp32``,
  float32): an NCCL world of one in this process, the flagship sharded over
  it (``Pipeline(...).compile().shard(default_mesh())``, the collective run
  all the same) and its value_and_grad captured with the ``all_reduce`` in
  the graph, against the unsharded captured flagship; and a float64 child
  (``--sharded-worker``) with a gloo world of 2 ranks on the one card, its
  sharded template and gradient against the unsharded card float64 ones to
  1e-12 and 1e-10, each rank's grid points and real layer steps printed;
- the public surface the port completed last (``api_fp32``): the
  ``init_test`` of 13 services (the flagship's stages among them, and the
  two gated on ``photospline`` and ``LeptonWeighter``) through
  ``testing/service_matrix.run_service`` on the card and on the CPU in both
  modes, each status the CPU's and none a failure; and the ``Container``
  helpers in float64 at the flagship's width (240,000 seeded events, the
  200x200 ``true_allsky_fine`` grid, the 8x8x2 output binning):
  ``array_to_binned`` (mean and sum), ``binned_to_array``, ``resample``
  onto toy_fit_example's 24x24 grid (the output binning's dimensions are
  reco ones, which a grid of true ones cannot be resampled onto) and
  ``keep`` on a seeded mask, each within 1e-12 of the largest entry of the
  same call on the CPU. It prints each status, each helper's card wall and
  worst error, and its wall against a budget of 10 s.

It times the kernels (device-only, from a CUDA graph of 200 launches, and
host-inclusive, from back-to-back launches between CUDA events; the
multitangent at K = 3 and K = 6 beside K launches of the tangent), checks
them with a lane axis (64 distinct lanes in one launch, the ensemble's
shapes, against the plain version and against single launches) and times
them device-only at 1, 16 and 64 of those lanes beside as many single
launches, prints their registers and occupancy, and
times ``value`` and ``value_and_grad`` by every route (per container,
stacked, stacked and captured; deferral on and off; host clock and device
time) with each route's launches, waits for the card and copies from the
host, and the fit. A ``value_and_grad`` that waits
for the card anywhere but at the read of its result fails the run. It exits
non-zero on any failed check; the last line of a passing run is
``{"ok": true, "device": {...}}``. With ``--kernels-only`` it stops after
the kernel checks and timings, with ``--release-only`` it builds the
kernels and runs the release phases alone, with ``--analysis-only`` the
phases of the rest of the analysis layer alone, and with
``--osc-options-only`` the phases of prob3's options alone, and with
``--osc-lanes-only`` the phases of forward mode and lanes under the options
alone, with ``--sterile-only`` the 3+1 and nusquids phases alone, and with
``--events-only`` the KDE kernel checks, the HDF5 and KDE phases and the
events-file workflow alone,
with ``--hypersurfaces-only`` the hypersurfaces phases alone, with
``--mceq-only`` the MCEq-Barr flagship's phases alone, with
``--param-only`` the parameterized-detector phases alone, with
``--cli-only`` the command-line phase alone (the CPU float64 nominal
template from a child of its own), with ``--sharded-only`` the sharded
flagship's phase and its float64 child alone, with ``--api-only`` the
public-surface phase alone; none prints a status line. It prints its total wall before the
kernels line.

The float64 runs (CPU reference and card) happen in child processes, since
the float type is chosen once per process (``PISA_TPU_FTYPE``); the main
process runs float32, the port's default. The eleven children of a full run
start together, after the kernel checks and before the float32 phases
(``run_children``): their CPU sides dominate them and none depends on
another, and the float32 phases' timings then run alone.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CFG = "settings/pipeline/IceCube_3y_neutrinos.cfg"
KERNEL_SOURCE = "pisa_tpu_torch/csrc/osc_chain.cu"
# each kernel's name and the TPU kernel it replaces (file:line)
KERNELS = {
    "osc_chain": "pisa_tpu/ops/osc/pallas_chain.py:562",
    "osc_chain_tangent": "pisa_tpu/ops/osc/pallas_chain.py:584",
    "osc_chain_multitangent": "pisa_tpu/ops/osc/pallas_chain.py:888",
}
FREE_THETA = (1, 2, 5)  # the flagship frees theta13, theta23, dm31

# H100 SXM peaks (NVIDIA data sheet): vector (non-tensor-core) float32 and
# float64 rates, HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
HBM_BYTES_PER_S = 3.35e12

# kernel vs plain version on the card (max abs difference of probabilities)
KERNEL_ATOL = {"float64": 1e-10, "float32": 1e-4}
# tangent (and multitangent tangents) vs plain, relative to the largest
# |tangent| of the direction: float64 differs by operation order; float32
# by rounding, which reaches 8.55e-5 on probabilities <= 1 in the primal
TANGENT_RTOL = {"float64": 1e-9, "float32": 1e-3}
# multitangent primal vs the plain primal and the primal kernel
MULTI_PRIMAL_ATOL = {"float64": 1e-10, "float32": 1e-4}
# card template vs CPU float64 template, relative per bin: float64 differs
# only by summation order (atomics, matmul blocking); float32 by rounding,
# judged on bins holding >= 1 expected event
TEMPLATE_RTOL = {"float64": 1e-9, "float32": 1e-4}
MIN_EVENTS_FP32 = 1.0

# value_and_grad of mod_chi2 at the perturbed point (see gradient_point):
# card float64 vs CPU float64, both in float64 up to operation order: value
# relative, gradient entry by entry (rtol, plus atol as a fraction of the
# largest |gradient|)
VG_FP64 = {"value": 1e-9, "grad_rtol": 1e-7, "grad_atol": 1e-9}
# central finite differences of the card float64 objective (h = 1e-5 in
# rescaled units) vs its analytic gradient: the truncation (h^2/6 times the
# third derivative) and the rounding (~eps |f| / h, ~3e-8 here) stay under
# these (rtol, plus atol as a fraction of the largest |gradient|)
FD_STEP = 1e-5
FD_TOL = {"rtol": 1e-4, "atol": 1e-7}
# separate tangent launches vs one multitangent launch per sign, in
# max |difference| / max |gradient|: the same arithmetic, fused differently
TANGENTS_VS_MULTI = {"float64": 1e-10, "float32": 1e-3}
# card float32 vs card float64 on the same data: the float32 template is
# within ~1.5e-6 per bin and the float32 tangents within ~3e-4 of their
# direction's largest, which the metric's (data - template) amplifies
VG_FP32 = {"value": 1e-4, "grad_rtol": 1e-2, "grad_atol": 1e-4}
# the Asimov fit recovers theta23 to this, in rescaled units
# (tests/test_device_fit.py:140)
FIT_TOL = 5e-3
# a replay of the captured value_and_grad vs a fresh eager run of the same
# stacked template on the card (float64): the same kernels in the same
# order, sums by atomics in any order; value relative, gradient in
# max |difference| / max |gradient|
REPLAY_FP64 = 1e-12
# float32 stacked (either route) vs float32 per container on the card: the
# same arithmetic summed in another order; gradient in max |difference| /
# max |gradient|
STACKED_FP32 = {"value": 1e-5, "grad": 1e-4}
# the captured template call vs a fresh eager run of the same template
# (float64), relative per bin; scan_totals vs the replays' totals, relative
TEMPLATE_REPLAY_FP64 = 1e-12
# randomized templates timed (bench.py:251-252: rescaled vectors uniform in
# [0.05, 0.95], seed 0); the first is excluded from the median
N_TEMPLATES = 100
# the device fit through Analysis may wait for the card at most this often
# per objective evaluation (one flag read per evaluation is the design)
DEVICE_FIT_WAITS = 2.0
# card vs CPU L-BFGS (float64, the 20x20-grid flagship): the same
# iterations, best fits within this (rescaled); the iteration cap is low
# because the CPU side takes ~3 s an iteration (the batched fits' parity
# below holds four more fits to the same rule; 8 until the command-line
# phase came, then 6 to keep the run in its time limit)
LBFGS_X_ATOL = 1e-8
LBFGS_MAX_STEPS = 6
# the batched kernels: lanes of one launch at the checks (the ensemble's
# trials: the main path's lanes), and the first of them at the timings
KERNEL_LANES = 64
KERNEL_TIME_LANES = (1, 16, 64)
# batched fits, float64, 20x20-grid flagship: lanes of distinct data, the
# iteration cap, and the bounds on each lane's best fit against its solo
# fit on the card (the same objective, its lanes in one program) and
# against the same batch on the CPU (another summation order)
BATCH_FIT_LANES = 4
BATCH_FIT_STEPS = 7
# ... and its stopping tolerance (the gradient's L2 norm in z), at which the
# lanes stop at different iterations (1, 6, 7 and 7 on the CPU; 1, 6, 10
# and 10 at the cap of 10 that held until the command-line phase came): the
# lanes that have stopped stay frozen while the others go on
BATCH_FIT_GTOL = 0.5
BATCH_SOLO_X_ATOL = 1e-10
BATCH_CPU_X_ATOL = 1e-9
# the float32 ensemble on the flagship: trials (lanes), iteration cap
# (fit_pseudo_ensemble's default), and the lanes the batched
# value_and_grad is timed at
ENSEMBLE_TRIALS = 64
ENSEMBLE_MAX_STEPS = 100
VG_LANES = (1, 16, 64)
# the per-container eager Asimov fit (unstacked, uncaptured) is cut to
# this many iterations: at float32 the reference's L-BFGS never meets gtol and
# runs to max_steps, which per container and eager takes over a minute on
# the card (PERF.md); theta23 is back within FIT_TOL long before
EAGER_FIT_STEPS = 40

# the IceCube 3-year data release's fit: the daemonflux neutrino variant
# (24 correlated flux parameters, the flux per event) and the muon pipeline
# against the released counts, at full width
DAEMON_CFG = "settings/pipeline/IceCube_3y_neutrinos_daemon.cfg"
MUON_CFG = "settings/pipeline/IceCube_3y_muons.cfg"
DATA_CFG = "settings/pipeline/IceCube_3y_data.cfg"
RELEASE_FREE = 36  # 24 daemon_*, 3 oscillation, 3 aeff, 5 hypersurface, muons
RELEASE_TRIALS = 64
RELEASE_MAX_STEPS = 100

# the rest of the analysis layer: the MC-uncertainty metrics, the
# generalized likelihood's toy pipeline at the flagship's event count, the
# Fisher matrix (float64 card vs CPU relative to its largest entry, pulls in
# units of each param's sigma; float32 Jacobian vs central differences of
# the captured template at steps h and h/2, extrapolated: error <= rtol
# max|column| + 3 noise max|template| / h, noise ~100 float32 epsilons) and
# the ensemble sampler
MC_METRICS = ("mcllh_mean", "mcllh_eff", "barlow_llh", "conv_llh")
GEN_CFG = "settings/pipeline/toy_generalized_llh.cfg"
GEN_EVENTS = 240000
FISHER_FP64 = 1e-9
FISHER_FD = {"step": 1e-2, "rtol": 1e-3, "noise": 1e-5}
MCMC_WALKERS = 32
MCMC_BURNIN = 20
MCMC_STEPS = 50

# prob3's options (NSI, decay, LRI, tomography, dedup, per-event calc
# mode): the 9 NSI couplings of StdNSIParams and their nominal values in the
# options phase (eps_mutau_magn free there); the event fraction of the
# per-event mode's float64 card-vs-CPU check. A captured float32
# value_and_grad is held against the eager one on the card within
# STACKED_FP32 (the same kernels, sums in another order)
NSI_NAMES = ("eps_ee", "eps_emu_magn", "eps_emu_phase", "eps_etau_magn",
             "eps_etau_phase", "eps_mumu", "eps_mutau_magn",
             "eps_mutau_phase", "eps_tautau")
NSI_NOMINAL = dict.fromkeys(NSI_NAMES, 0.0) | {"eps_mutau_magn": 0.02}
OPTIONS_FP64_FRACTION = 0.05

# forward mode and lanes under the options: the general packs' lanes (one
# launch against the plain version and against single launches), the
# Fisher matrices' card-vs-CPU bound (float64, per entry: relative, and of
# sqrt(F_ii F_jj) for entries that are round-off of a zero correlation),
# the float64 phases' event fractions (the CPU's share of their wall), the
# NSI ensemble's
# trials and steps (16 trials; a further count runs only where its multiple
# of the 16-trial peak fits in the card's free memory; the 64-trial run was
# cut to keep the whole script in its time limit) and the NSI sampler's
# walkers and steps
GENERAL_LANES = 16
FISHER_OPTIONS_RTOL = 1e-9
FISHER_OPTIONS_ZERO = 1e-12
OPTIONS_LANES_FP64_FRACTION = 0.25
OPTIONS_BATCH_FRACTION = 0.0025
OPTIONS_TRIALS = (16,)
OPTIONS_ENSEMBLE_STEPS = 10
OPTIONS_MCMC = {"walkers": 32, "burnin": 10, "steps": 40}

# 3+1 sterile oscillations (osc.nusquids with 4 flavours on the flagship,
# testing/sterile_flagship.py) and the kernel of their layer step's
# eigenvalues, which is no port of a Pallas kernel: it replaces the XLA
# eigvalsh of the JAX package's 3+1 engine
HERM4_SOURCE = "pisa_tpu_torch/csrc/herm4_eig.cu"
HERM4_REPLACES = "pisa_tpu/ops/osc/sterile.py:125 _eigvals_hermitian4"
# herm4_eig vs its plain version (torch.linalg.eigh) on the same matrices,
# eigenvalues relative to the matrix's norm: float64 to its round-off,
# float32 within a few of its epsilons (both versions round)
HERM4_TOL = {"float64": 1e-12, "float32": 2e-6}
# cuSOLVER's batched Hermitian eigensolver refuses 32,768 4x4 matrices and
# more in one call on the card machine (CUSOLVER_STATUS_INVALID_VALUE; 4,096
# run): the plain version runs in chunks of this size there
HERM4_CHUNK = 4096
# the float64 jvp and backward vs central differences of the kernel along a
# direction of the size of each matrix's smallest eigenvalue gap, relative
# to that gap: truncation ~step^2 / 6, rounding ~eps |H| / (gap step)
HERM4_FD = {"step": 1e-3, "tol": 1e-5, "min_gap": 1e-7, "matrices": 20000}
STERILE_CFG = "settings/pipeline/sterile_example.cfg"
STERILE_ANGLES = ("theta12", "theta13", "theta23", "theta14", "theta24",
                  "theta34", "deltacp", "deltacp14", "deltacp24")
STERILE_FREE = 17  # the flagship's 15 and theta24, theta34
STERILE_MOVE = 0.10  # the 3+1 fit starts from theta24 moved by this, rescaled
# the 3+1 device fit's most L-BFGS iterations: its evaluations cost ~0.13 s
# each (the per-container 3+1 value_and_grad); at 200 iterations the fit
# took 793 of them and 104 s, most at the float32 noise floor, and at 40
# it stopped 5.5e-3 rescaled off theta24's truth
STERILE_FIT_STEPS = 80
# the 3+1 ensemble's trials (8 until the HDF5 and KDE phases joined the run:
# cut to keep the whole script in its time limit)
STERILE_TRIALS = 4
STERILE_ENSEMBLE_STEPS = 10
# osc.nusquids with 3 flavours (the general-pack route) vs prob3 (the
# standard route) on the 20x20-grid flagship, float64 on the card: each bin
# within this of its map's largest (the same physics, two packs)
NUSQUIDS3_TOL = 1e-11
# float32 row sums of the 3+1 engine at the TeV resonance
# (tests/test_sterile.py:304-341, the JAX package's bound)
STERILE_ROW_SUM = 2e-5

# the HDF5 event path and the KDE stage: the four configs that read the
# repo's HDF5 events file (card vs CPU in float64, read by the port's reader
# with h5py unimportable), and the full-width KDE run. The two KDE kernels
# are no port of a Pallas kernel: they replace the XLA contraction of the
# JAX package's adaptive KDE (pisa_tpu/utils/kde.py:101-115)
HDF5_CFGS = ("example", "fast_example", "varbin_example", "kde_example")
KDE_CFG = "settings/pipeline/kde_example.cfg"
EXAMPLE_CFG = "settings/pipeline/example.cfg"
KDE_SOURCE = "pisa_tpu_torch/csrc/kde_gauss.cu"
KDE_REPLACES = "pisa_tpu/utils/kde.py:53 adaptive_gaussian_kde"
# make_toy_events' events per flavour and interaction at full width (12
# categories: 240,000 events, the flagship's count) and in the float64
# card-vs-CPU check of the same path, and its seed
TOY_EVENTS = 20_000
TOY_EVENTS_FP64 = 2_000
TOY_SEED = 0
# the events-file workflow (events_file_fp32): events per flavour and
# interaction (12 categories: 240,000 events) and the sources' seed; the
# float32 template's bound against the float64 one of the same file
# (relative, bins >= 1 event; cli_fp32's flagship template came within
# 8.6e-7); the laned histogram's lanes, its reco binning (16 x 20 x 2 = 640
# bins, past the one-hot budget of 512 bins) and its bound against the
# unlaned calls (of the largest bin: atomics reorder the float32 sums); the
# phase's wall budget
EVENTS_FILE_PER_FLAVINT = 20_000
EVENTS_FILE_SEED = 0
EVENTS_FILE_RTOL = 3e-6
EVENTS_FILE_LANES = 4
EVENTS_FILE_FINE_BINS = (16, 20)
EVENTS_FILE_LANES_ATOL = 1e-5
# the laned map-to-map resampling check (toy_fit_example's probabilities
# from a grid of this many bins a side): each lane vs its unlaned call, of
# the largest bin
RESAMPLE_GRID_BINS = 200
RESAMPLE_LANES_ATOL = 1e-6
EVENTS_FILE_BUDGET_S = 30
# KDE kernel vs its plain version on the same inputs, max |difference| /
# max |plain|: float64 to the round-off of 20,000-term sums; the float32
# kernel against the float32 plain version (the same terms summed in
# another order) and against the float64 one (float32's rounding of the
# inputs and of the 20,000-term sums: 1.3e-5 measured)
KDE_KERNEL_RTOL = {"float64": 1e-12, "float32": 1e-4}
# the kde_example device fit's most L-BFGS iterations: at float32 the fit
# meets no gtol and ran all 200 (2,579 evaluations, 69 s), and all 60 of a
# cap at 60 (659 evaluations, 17 s), with theta23 within 1.5e-7 of its
# truth at either
KDE_FIT_STEPS = 30
# the float64 density's directional derivative (its backward) against
# central differences with steps of this size relative to w and h:
# truncation ~step^2, rounding ~1e-16 / step
KDE_FD = {"step": 1e-5, "rtol": 1e-6}
# kde_gauss_sum_jvp's tangents in its check against the plain version:
# seeded directions of up to this fraction of ih, il2 and c (the kernels'
# tolerance is the sum's, KDE_KERNEL_RTOL); the Fisher matrix of the toy
# kde_example, card against CPU in float64, max |difference| / max |F|
KDE_JVP_DIRECTION = 0.1
KDE_FISHER_RTOL = 1e-9
# the jvp's directions in its check: kde_example's Fisher matrix's (3 free
# params, one launch at the samples and one at the points)
KDE_JVP_K = 3
# the host C route of the generalized likelihood against the torch route
# on the generalized toy's bins: the reference test's tolerances
# (tests/test_generalized_llh.py: two summation orders of one recursion)
C_ROUTE_TOL = {"rtol": 1e-10, "atol": 1e-12}

# the MCEq-Barr flagship (pisa_tpu_torch/testing/mceq_flagship.py): its
# free params (the flagship's 11 besides barr_simple's, mceq_barr's 18 Barr
# params and delta_index, nutau_xsec_scale), the device fit's most L-BFGS
# iterations (the fit runs at each cap; the last one is held to FIT_TOL:
# with 31 free parameters 30 iterations need not bring theta23 that close,
# and the first run prints where they leave it), and the synthetic events (two containers, the service
# matrix's) of the three cross-section services whose keys the flagship's
# CSV lacks, held card against CPU in float64 (1e-12 of the largest
# weight and gradient entry: the same arithmetic) at these parameter values
MCEQ_FREE = 31
MCEQ_FIT_STEPS = (30, 60)
MCEQ_XSEC_EVENTS = 240_000
MCEQ_XSEC = {"dis_sys": {"dis_csms": 0.6},
             "genie_sys": {"Genie_Ma_QE": -0.4, "Genie_Ma_RES": 0.7},
             "correct_charm_y": {}}
XSEC_RTOL = 1e-12

# the parameterized-detector path (pisa_tpu_torch/testing/param_detector.py:
# toy events -> barr_simple -> prob3 -> aeff.param -> reco.simple_param ->
# reco.resolutions -> hist -> fix_error): its free params (delta_index,
# theta23, deltam31, aeff_scale) and the multitangent's directions
# (theta23, Delta m^2_31); the synthetic events of the service checks (two
# containers, the service matrix's), held card against CPU in float64
# within XSEC_RTOL (the random streams exactly). PARAM_SERVICES: case ->
# (stage package, module, its options or None for its init_test, the keys
# compared, the parameter values it runs at, {key: f} replacing the
# harness's synthetic values x by f(x) where they would make the output
# trivial); the cases with random streams are PARAM_EXACT
PARAM_FREE = 4
PARAM_THETA = (2, 5)
PARAM_EVENTS = 240_000
# the float64 child's CPU threads (it runs beside the other children)
PARAM_FP64_THREADS = 1
PARAM_SERVICES = {
    "aeff.param": ("aeff", "param", None, ("weights",),
                   {"aeff_scale": 1.3, "livetime": 12.0}, {}),
    "aeff.weight": ("aeff", "weight", None, ("weights",),
                    {"weight_scale": 0.8, "livetime": 2.0}, {}),
    "aeff.weight_hnl": ("aeff", "weight_hnl", None, ("weights",),
                        {"U_tau4_sq": 2e-2},
                        {"hnl_decay_width": lambda x: x * 1e-16}),
    "reco.simple_param": ("reco", "simple_param", None,
                          ("reco_energy", "reco_coszen", "pid"), {}, {}),
    "reco.resolutions": ("reco", "resolutions", None,
                         ("reco_energy", "reco_coszen", "pid"), {}, {}),
    "utils.adhoc_sys": ("utils", "adhoc_sys", None, ("weights",), {}, {}),
    "utils.bootstrap": ("utils", "bootstrap", {"seed": 11},
                        ("weights", "bootstrap_weights"), {}, {}),
    "utils.fix_error": ("utils", "fix_error", None, ("errors",), {}, {}),
    "utils.kfold": ("utils", "kfold",
                    {"n_splits": 3, "select_split": 1, "seed": 5,
                     "shuffle": True, "save_mask": True},
                    ("weights", "fold_weight", "kfold_mask"), {}, {}),
    "utils.set_variance": ("utils", "set_variance", None,
                           ("errors", "manual_variance"), {}, {}),
    "data.grid": ("data", "grid", None,
                  ("true_energy", "true_coszen", "weights"), {}, {}),
    "data.sqlite_loader": ("data", "sqlite_loader", None,
                           ("true_energy", "reco_energy", "pid",
                            "weighted_aeff"), {}, {}),
    "cont_sys.snowstorm_hist": ("cont_sys", "snowstorm_hist", None,
                                ("weights", "syst_scale"), {"dom_eff": 1.02},
                                {"dom_eff": lambda x: 0.7 + 0.6 * x}),
    "hist.apply_unc_weights": ("utils", "hist",
                               {"apply_unc_weights": True,
                                "error_method": "sumw2"},
                               ("weights", "errors", "bin_unc2"), {}, {}),
    "hist.unweighted": ("utils", "hist",
                        {"unweighted": True, "error_method": "sumw2"},
                        ("weights", "errors", "bin_unc2"), {}, {}),
    "hist.binned_calc": ("utils", "hist",
                         {"calc_mode": "reco", "apply_unc_weights": True,
                          "error_method": "sumw2"},
                         ("weights", "errors", "bin_unc2"), {}, {}),
}
PARAM_EXACT = {"reco.simple_param", "utils.bootstrap", "utils.kfold"}

# hypersurfaces on the flagship (bench.py:640-720's 13-dataset, 3-param
# design): the forms of three free pipeline params, the nominal point and 12
# systematic points, the regexes that combine the 12 maps into the
# hypersurfaces stage's four link groups (and those groups' names), the
# Delta m^2_31 grid of the interpolated fits and csv_hypersurfaces (it holds
# gradient_point's Delta m^2_31), and the point between grid values where
# the interpolated fits are applied
HS_PARAMS = {"delta_index": "linear", "Barr_uphor_ratio": "quadratic",
             "nu_nc_norm": "linear"}
HS_NOMINAL = {"delta_index": 0.0, "Barr_uphor_ratio": 0.0, "nu_nc_norm": 1.0}
HS_POINTS = [
    {"delta_index": d, "Barr_uphor_ratio": b, "nu_nc_norm": n}
    for d, b, n in ((-0.10, 0.0, 1.0), (0.10, 0.0, 1.0), (0.0, -1.0, 1.0),
                    (0.0, 1.0, 1.0), (0.0, 0.0, 0.8), (0.0, 0.0, 1.2),
                    (-0.05, -0.5, 0.9), (0.05, 0.5, 1.1), (-0.08, 0.8, 1.15),
                    (0.08, -0.8, 0.85), (0.03, -0.3, 0.95), (-0.03, 0.3, 1.05))
]
HS_GROUPS = {"nue(bar)?_cc": "nue_cc+nuebar_cc",
             "numu(bar)?_cc": "numu_cc+numubar_cc",
             "nutau(bar)?_cc": "nutau_cc+nutaubar_cc",
             "nu.*_nc": "nu_nc+nubar_nc"}
HS_DM31 = [1.8e-3, 2.5e-3, 3.2e-3]
HS_DM31_POINT = 2.457e-3
# card vs CPU, float64: the applied templates' maps (worst bin over each
# map's largest), the fitted coefficients from the same maps and their
# covariances (valid bins; each relative to its bin's largest: the
# intercept, ~1, for the coefficients); float32 coefficients against a
# float64 fit of the same float32 maps (the same measure)
HS_MAPS_FP64 = 1e-12
HS_COEFF_FP64 = 1e-10
HS_COV_FP64 = 1e-8
HS_COEFF_FP32 = 1e-4
# the applied flagship's device fit: its most L-BFGS iterations (float32
# meets no gtol; the kde_example fit's cap)
HS_FIT_STEPS = 30

# the interpolated workflow's events in the float64 child (a fraction of
# the flagship's, by the loader's deterministic stride), and the child's
# CPU threads: it runs beside the other children (on the H100 80GB HBM3
# machine at 700 W, alone 89 s; beside them with torch's default threads
# 406 s, the reference child, the longest, then 478 s; with 2 threads 214
# and 282 s)
HS_FP64_FRACTION = 0.05
HS_FP64_THREADS = 2

# the command-line phase: requests the llh server answers (each against
# this process's objective), how long its first answer may take (a new
# process, the flagship's set-up, the capture), and the phase's budget
CLI_REQUESTS = 16
CLI_SERVER_TIMEOUT = 180.0
CLI_BUDGET_S = 60.0

# the sharded flagship (parallel/, CompiledTemplate.shard): the float32
# phase's budget; the float64 child's gloo ranks, every one on cuda:0; its
# bounds against the unsharded card float64 flagship (relative per bin;
# relative per gradient entry, plus that fraction of the largest)
SHARDED_BUDGET_S = 30
SHARDED_WORLD = 2
SHARDED_FP64 = {"template": 1e-12, "grad": 1e-10}

# the public-surface phase: the services whose init_test it runs on the
# card and on the CPU (the 11 that had none before it, then the 2 gated on a
# package), the Container helpers' events (the flagship's count), their
# bound against the CPU (of the largest entry), and the phase's budget
API_SERVICES = (
    ("aeff", "aeff"), ("data", "csv_data_hist"), ("data", "csv_icc_hist"),
    ("data", "csv_loader"), ("data", "toy_event_generator"),
    ("flux", "barr_simple"), ("flux", "daemon_flux"), ("flux", "honda_ip"),
    ("likelihood", "generalized_llh_params"), ("osc", "prob3"),
    ("utils", "add_indices"), ("flux", "airs"),
    ("data", "licloader_weighter"),
)
API_EVENTS = 240_000
API_TOL = 1e-12
API_BUDGET_S = 10.0

# the routes of one value_and_grad: label, compile options, captured
ROUTES = (
    ("per-container eager", {"stack": False}, False),
    ("stacked eager, gather", {"rate_defer": False}, False),
    ("stacked eager, deferral", {"rate_defer": True}, False),
    ("stacked captured, gather", {"rate_defer": False}, True),
    ("stacked captured, deferral", {"rate_defer": True}, True),
)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"CHECK FAILED: {msg}")


def param_points(ureg):
    """The three template points, as in tests/test_icecube_3y.py: nominal;
    theta23 and deltam31 moved; opt_eff_overall moved. Each entry: (label,
    changes, whether the oscillation parameters changed)."""
    return [
        ("nominal", {}, True),
        ("theta23+dm31", {"theta23": 42.0 * ureg.degree,
                          "deltam31": 2.3e-3 * ureg.eV**2}, True),
        ("opt_eff_overall", {"opt_eff_overall": 1.1 * ureg.dimensionless},
         False),
    ]


def run_points(pipeline, ureg, chain):
    """get_outputs at each point; returns {label: (hist dict, err dict)} and
    the kernel launches each point made."""
    out, launches = {}, {}
    for label, changes, _ in param_points(ureg):
        for name, value in changes.items():
            pipeline.params[name].value = value
        before = chain.launch_count
        maps = pipeline.get_outputs()
        launches[label] = chain.launch_count - before
        out[label] = (
            {m.name: m.hist for m in maps},
            {m.name: m.error_hist for m in maps},
        )
    return out, launches


def max_rel(ref, got, mask=None):
    import numpy as np

    ref = np.asarray(ref, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    denom = np.where(ref != 0, np.abs(ref), 1.0)
    rel = np.abs(got - ref) / denom
    if mask is not None:
        rel = rel[mask]
    return float(rel.max()) if rel.size else 0.0


def check_template(out, label):
    """The repo's own sanity checks of a flagship template
    (tests/test_icecube_3y.py): 12 finite non-negative maps of 8x8x2 bins, a
    sane expected-event count, numu CC above nue CC, errors present."""
    import numpy as np

    hists, errs = out
    check(len(hists) == 12, f"{label}: {len(hists)} maps, expected 12")
    for name, h in hists.items():
        check(h.shape == (8, 8, 2), f"{label}: {name} shape {h.shape}")
        check(np.all(np.isfinite(h)) and np.all(h >= 0),
              f"{label}: {name} has non-finite or negative bins")
        check(errs[name] is not None and np.all(np.isfinite(errs[name])),
              f"{label}: {name} errors missing or non-finite")
    total = sum(float(h.sum()) for h in hists.values())
    check(1e3 < total < 1e6, f"{label}: total {total} expected events")
    check(hists["numu_cc"].sum() > hists["nue_cc"].sum(),
          f"{label}: numu CC not above nue CC")
    return total


# -- the gradient path: shared by both processes --------------------------------
def launch_counts(chain):
    return (chain.launch_count, chain.tangent_launch_count,
            chain.multitangent_launch_count)


def reset_launch_counts(chain):
    chain.launch_count = 0
    chain.tangent_launch_count = 0
    chain.multitangent_launch_count = 0


def expected_vg_launches(multitangent):
    """(primal, tangent, multitangent) launches of one value_and_grad: the
    two primal launches (nu, nubar) of the forward, then per sign one
    tangent launch per free oscillation parameter, or one multitangent
    launch."""
    if multitangent:
        return (2, 0, 2)
    return (2, 2 * len(FREE_THETA), 0)


def gradient_point(ct, seed=5):
    """The value_and_grad point: the nominal rescaled values clipped to
    [0.15, 0.85] (tests/test_rate_defer.py:79-94) plus a seeded offset in
    [-0.1, 0.1], clipped again (test_rate_defer.py:97-116), so that the
    objective is away from its minimum at the nominal Asimov data."""
    import numpy as np

    v0 = np.clip(ct.current_rescaled_values(), 0.15, 0.85)
    rng = np.random.RandomState(seed)
    return np.clip(v0 + rng.uniform(-0.1, 0.1, v0.size), 0.15, 0.85)


def captured_launches(template_module):
    """(primal, tangent, multitangent) launches that build_objective makes
    when it captures: the launch counts advance where the wrappers launch,
    at the warm-up runs and the capture, and not at a replay. Each run of
    value_and_grad makes 2 primal + 2 multitangent (prob3's default route),
    each run of the value 2 primal."""
    runs = template_module.CAPTURE_WARMUP + 1
    return (2 * runs + 2 * runs, 0, 2 * runs)


def first_call_runs(ct, template_module):
    """How often the first call of a template runs its stages: once, or on
    a capturing template the warm-up runs and the capture."""
    return template_module.CAPTURE_WARMUP + 1 if ct.capture else 1


def deferred_calls(fn):
    """How often the histogram stage took the factorized (rate-deferred)
    route in fn()."""
    from pisa_tpu_torch.stages.utils.hist import hist

    calls = []
    original = hist._apply_stacked_deferred

    def counted(self, container, dr):
        calls.append(container)
        return original(self, container, dr)

    hist._apply_stacked_deferred = counted
    try:
        fn()
    finally:
        hist._apply_stacked_deferred = original
    return len(calls)


def value_and_grad_counted(pipeline, chain, vg, v, multitangent):
    """One value_and_grad with the backward's tangent route chosen; returns
    the value, the gradient (numpy) and the kernel launches it made."""
    import torch

    stage = pipeline["osc.prob3"]
    default, stage.multitangent = stage.multitangent, multitangent
    try:
        before = launch_counts(chain)
        value, grad = vg(v)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        after = launch_counts(chain)
    finally:
        stage.multitangent = default
    return (float(value), grad.cpu().numpy(),
            tuple(a - b for a, b in zip(after, before)))


def rel_max(got, want):
    """max |got - want| / max |want|."""
    import numpy as np

    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def grad_mismatch(got, want, rtol, atol_fraction):
    """Worst entry of |got - want| / (rtol |want| + atol_fraction max|want|):
    at most 1 when every entry is within its bound."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    allowed = rtol * np.abs(want) + atol_fraction * np.abs(want).max()
    return float((np.abs(got - want) / allowed).max())


def gradient_worker(cpu_pipeline, gpu_pipeline, chain):
    """float64 value_and_grad of mod_chi2 at full width: the CPU and the
    card per container (eager), the card's central finite differences,
    separate tangents against the multitangent; then the stacked and
    captured program on the card (stacked_captured_fp64). Returns arrays for
    the npz."""
    import numpy as np

    for pipeline in (cpu_pipeline, gpu_pipeline):
        pipeline.params.reset_all()
    # the reference: per container on the CPU, no part of it stacked
    cpu_ct = cpu_pipeline.compile(stack=False)
    data = cpu_ct.get_outputs()  # Asimov data at nominal
    v = gradient_point(cpu_ct)
    _, cpu_vg = cpu_ct.build_objective(data, "mod_chi2")
    # the CPU takes the plain tangents; the one-pass (batched) multitangent
    # is the quicker of the two there, and gives the same gradient
    t0 = time.perf_counter()
    cpu_value, cpu_grad, _ = value_and_grad_counted(
        cpu_pipeline, chain, cpu_vg, v, True)
    cpu_seconds = time.perf_counter() - t0
    cpu_template = cpu_ct.get_outputs(v)

    ct = gpu_pipeline.compile(stack=False)
    check(ct.free_names == cpu_ct.free_names, "free params differ")
    value_fn, vg = ct.build_objective(data, "mod_chi2", capture=False)
    value, grad, launches = value_and_grad_counted(gpu_pipeline, chain, vg,
                                                   v, False)
    value_m, grad_m, launches_m = value_and_grad_counted(gpu_pipeline, chain,
                                                         vg, v, True)
    fd = np.empty_like(grad)
    for i in range(v.size):
        step = np.zeros_like(v)
        step[i] = FD_STEP
        fd[i] = (float(value_fn(v + step)) - float(value_fn(v - step))) / (
            2 * FD_STEP)
    stacked_captured_fp64(gpu_pipeline, chain, data, v, cpu_value, cpu_grad,
                          cpu_template)
    out = {
        "vg|free_names": np.asarray(ct.free_names),
        "vg|v": v,
        "vg|cpu_value": np.asarray(cpu_value),
        "vg|cpu_grad": cpu_grad,
        "vg|cpu_seconds": np.asarray(cpu_seconds),
        "vg|value": np.asarray(value),
        "vg|grad": grad,
        "vg|value_multi": np.asarray(value_m),
        "vg|grad_multi": grad_m,
        "vg|fd": fd,
        "vg|launches": np.asarray(launches),
        "vg|launches_multi": np.asarray(launches_m),
    }
    for m in data:
        out[f"data|{m.name}"] = np.asarray(m.hist)
    return out


def stacked_captured_fp64(pipeline, chain, data, v, cpu_value, cpu_grad,
                          cpu_template):
    """float64 on the card, the categories stacked, value_and_grad captured,
    with rate deferral on and off: the template at `v` against the CPU's
    per bin, the captured value and gradient against the CPU's; a replay
    against a fresh eager run of the same template at `v`, at a second
    point and after a change of theta23's range. Prints and checks here (in
    the float64 child)."""
    import torch

    from pisa_tpu_torch.core import template as template_module

    for defer in (True, False):
        tag = f"float64 stacked, {'deferral' if defer else 'gather'}"
        ct = pipeline.compile(rate_defer=defer)
        check(ct.stacked and ct.rate_deferred is defer,
              f"{tag}: the template reports stacked={ct.stacked},"
              f" rate_deferred={ct.rate_deferred}")
        maps = []
        took_deferred = deferred_calls(lambda: maps.append(ct.get_outputs(v)))
        check(took_deferred == first_call_runs(ct, template_module) * defer,
              f"{tag}: {took_deferred} factorized histograms in the first"
              " template")
        worst_w = max(max_rel(m.hist, maps[0][m.name].hist)
                      for m in cpu_template)
        worst_e = max(max_rel(m.error_hist, maps[0][m.name].error_hist)
                      for m in cpu_template)
        print(f"{tag}: template at the gradient point vs CPU float64"
              f" (per container), all bins: max rel weights {worst_w:.3e},"
              f" errors {worst_e:.3e} (bound {TEMPLATE_RTOL['float64']:g})")
        check(max(worst_w, worst_e) <= TEMPLATE_RTOL["float64"],
              f"{tag}: template off the CPU reference")

        _, eager_vg = ct.build_objective(data, "mod_chi2", capture=False)
        before = launch_counts(chain)
        t0 = time.perf_counter()
        _, vg = ct.build_objective(data, "mod_chi2")
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        made = tuple(a - b for a, b in zip(launch_counts(chain), before))
        check(made == captured_launches(template_module),
              f"{tag}: launches at capture {made}")
        value, grad = vg(v)
        value, grad = float(value), grad.cpu().numpy()
        check(launch_counts(chain) == tuple(
            b + m for b, m in zip(before, made)),
            f"{tag}: a replay advanced the launch counts")
        value_err = abs(value - cpu_value) / abs(cpu_value)
        grad_err = grad_mismatch(grad, cpu_grad, VG_FP64["grad_rtol"],
                                 VG_FP64["grad_atol"])
        print(f"{tag}, captured (capture {capture_s:.2f} s, launches at"
              f" capture {made}): value {value!r} vs CPU {cpu_value!r} (rel"
              f" {value_err:.3e}, bound {VG_FP64['value']:g}); gradient"
              f" {rel_max(grad, cpu_grad):.3e} of max|g|, worst entry at"
              f" {grad_err:.3e} of its bound")
        check(value_err <= VG_FP64["value"], f"{tag}: value off the CPU's")
        check(grad_err <= 1.0, f"{tag}: gradient off the CPU's")

        def replay_vs_eager(label, point):
            want_v, want_g = eager_vg(torch.as_tensor(point, device="cuda"))
            got_v, got_g = vg(point)
            v_err = abs(float(got_v) - float(want_v)) / abs(float(want_v))
            g_err = rel_max(got_g.cpu().numpy(), want_g.cpu().numpy())
            print(f"  replay vs fresh eager run, {label}: value"
                  f" {float(got_v)!r}, rel {v_err:.3e}; gradient {g_err:.3e}"
                  f" of max|g| (bound {REPLAY_FP64:g})")
            check(v_err <= REPLAY_FP64 and g_err <= REPLAY_FP64,
                  f"{tag}: replay off the eager run ({label})")
            return float(got_v)

        first = replay_vs_eager("the gradient point", v)
        second = replay_vs_eager("another point", gradient_point(ct, seed=6))
        theta23 = pipeline.params["theta23"]
        saved = theta23.range
        lo, hi = saved
        theta23.range = (lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo))
        try:
            narrowed = replay_vs_eager("theta23's range narrowed", v)
        finally:
            theta23.range = saved
        check(len({first, second, narrowed}) == 3,
              f"{tag}: the replays did not follow their inputs")
        del vg


def template_fp64(pipeline, smi):
    """float64 on the card: the captured template call (compile()'s
    default) against a fresh eager run of the same template, per bin, at two
    points and after a change of theta23's range; scan_totals against the
    totals of the calls and of the eager template's scan. Prints and checks
    here (in the float64 child)."""
    import numpy as np
    import torch

    ct = pipeline.compile()
    eager = pipeline.compile(capture=False)
    check(ct.capture and not eager.capture, "compile()'s template does not"
          " capture on the card")

    def replay_vs_eager(label, point):
        got, want = ct.get_outputs(point), eager.get_outputs(point)
        worst = max(max(max_rel(m.hist, got[m.name].hist),
                        max_rel(m.error_hist, got[m.name].error_hist))
                    for m in want)
        total = sum(float(m.hist.sum()) for m in got)
        print(f"float64 captured template call vs a fresh eager run, {label}:"
              f" {total!r} expected events, max rel per bin (weights and"
              f" errors) {worst:.3e} (bound {TEMPLATE_REPLAY_FP64:g}) [{smi}]")
        check(worst <= TEMPLATE_REPLAY_FP64,
              f"captured template call off the eager run ({label})")
        return total

    first = replay_vs_eager("the gradient point", gradient_point(ct))
    second = replay_vs_eager("another point", gradient_point(ct, seed=6))
    theta23 = pipeline.params["theta23"]
    saved = theta23.range
    lo, hi = saved
    theta23.range = (lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo))
    try:
        narrowed = replay_vs_eager("theta23's range narrowed",
                                   gradient_point(ct))
    finally:
        theta23.range = saved
    check(len({first, second, narrowed}) == 3,
          "the captured template calls did not follow their inputs")

    vecs = np.random.RandomState(0).uniform(0.05, 0.95,
                                            (8, len(ct.free_names)))
    scanned = ct.scan_totals(vecs).cpu().numpy()
    called = [float(ct._stack_outputs(ct(v))[2]) for v in vecs]
    eager_scanned = eager.scan_totals(
        torch.as_tensor(vecs, device=pipeline.device)).cpu().numpy()
    err_calls, err_eager = max_rel(called, scanned), max_rel(eager_scanned,
                                                             scanned)
    print(f"float64 scan_totals over {len(vecs)} vectors vs the calls'"
          f" totals: max rel {err_calls:.3e}; vs the eager template's scan:"
          f" {err_eager:.3e} (bound {TEMPLATE_REPLAY_FP64:g}) [{smi}]")
    check(max(err_calls, err_eager) <= TEMPLATE_REPLAY_FP64,
          "scan_totals off the calls")
    del ct, eager


def small_grid_config():
    """The flagship config with the true_allsky_fine oscillation grid cut
    to 20x20 over the same domains (tests/test_torch_pipeline.py:
    _small_grid_config), for a fit that the CPU runs in a minute."""
    from pisa_tpu_torch import ureg
    from pisa_tpu_torch.config.parser import parse_pipeline_config
    from pisa_tpu_torch.core import binning

    config = parse_pipeline_config(CFG)
    grid = binning.MultiDimBinning([
        binning.OneDimBinning("true_energy", num_bins=20, is_log=True,
                              domain=[1, 1000] * ureg.GeV),
        binning.OneDimBinning("true_coszen", num_bins=20, is_lin=True,
                              domain=[-1, 1]),
    ], name="true_allsky_fine")
    for key, settings in config.items():
        if isinstance(key, tuple):
            for mode in ("calc_mode", "apply_mode"):
                if getattr(settings.get(mode), "name", None) == grid.name:
                    settings[mode] = grid
    return config


def lbfgs_parity_fp64(smi):
    """float64: the port's minimize_on_device on the card (captured
    objective) and on the CPU (eager) over the 20x20-grid flagship, from
    theta23 + 0.10 rescaled: the same iterations and best fit."""
    import numpy as np

    from pisa_tpu_torch.analysis.device_fit import minimize_on_device
    from pisa_tpu_torch.core.pipeline import Pipeline

    fits = {}
    for device in ("cuda", "cpu"):
        ct = Pipeline(small_grid_config(), device=device).compile()
        v0 = ct.current_rescaled_values()
        value_fn, _ = ct.build_objective(ct.get_outputs(v0), "mod_chi2")
        i23 = ct.free_names.index("theta23")
        x0 = v0.copy()
        x0[i23] = min(0.95, x0[i23] + 0.10)
        t0 = time.perf_counter()
        fits[device] = minimize_on_device(
            value_fn.raw, x0, *ct._current_bounds(),
            max_steps=LBFGS_MAX_STEPS, device=device)
        fit = fits[device]
        print(f"float64 L-BFGS, 20x20-grid flagship, {device}: nit"
              f" {fit['nit']}, nfev {fit['nfev']}, flag reads {fit['reads']},"
              f" fun {fit['fun']!r}; wall {time.perf_counter() - t0:.2f} s"
              f" [{smi}]")
    dx = float(np.abs(fits["cuda"]["x"] - fits["cpu"]["x"]).max())
    print(f"float64 L-BFGS card vs CPU: nit {fits['cuda']['nit']} vs"
          f" {fits['cpu']['nit']}, max |dx| {dx:.3e} rescaled (bound"
          f" {LBFGS_X_ATOL:g}) [{smi}]")
    check(fits["cuda"]["nit"] == fits["cpu"]["nit"],
          "card and CPU L-BFGS took different iterations")
    check(dx <= LBFGS_X_ATOL, "card and CPU L-BFGS best fits differ")


def batch_parity_fp64(smi):
    """float64, the batched fits on the 20x20-grid flagship:
    BATCH_FIT_LANES lanes, fit by fit_batch_on_device on the card and on
    the CPU, and each lane by itself (minimize_on_device over the
    single-lane objective of its data) on the card: the same iterations
    lane by lane, best fits within BATCH_SOLO_X_ATOL and BATCH_CPU_X_ATOL.
    Lane 0 fits the Asimov template from the nominal values (its optimum:
    it stops after one iteration), lane 1 the Asimov template from theta23
    + 0.01 rescaled, lanes 2 and 3 seeded Poisson data of it from the
    nominal values and from theta23 + 0.05; at BATCH_FIT_GTOL they stop at
    different iterations, which the check requires."""
    from pisa_tpu_torch.core.pipeline import Pipeline

    batch_parity("20x20-grid flagship",
                 {device: Pipeline(small_grid_config(), device=device)
                  for device in ("cuda", "cpu")}, smi, require_spread=True)


def batch_parity(label, pipelines, smi, require_spread):
    """batch_parity_fp64's fits and checks on `pipelines` ({device:
    Pipeline} of one config, on the card and on the CPU);
    `require_spread`: the lanes must stop at different iterations (else
    that is printed only)."""
    import numpy as np

    from pisa_tpu_torch.analysis.device_fit import (
        fit_batch_on_device,
        minimize_on_device,
    )
    from pisa_tpu_torch.analysis.gradient import CompiledDistribution

    cds = {device: CompiledDistribution(pipelines[device])
           for device in ("cuda", "cpu")}
    x0 = cds["cpu"].current_rescaled_values()
    asimov = cds["cpu"].sum_hist(x0)
    rng = np.random.RandomState(20261017)
    data = rng.poisson(np.clip(asimov, 0, None),
                       (BATCH_FIT_LANES, asimov.size)).astype(np.float64)
    data[:2] = asimov
    x0s = np.tile(x0, (BATCH_FIT_LANES, 1))
    i23 = cds["cpu"].free_names.index("theta23")
    x0s[1, i23] += 0.01
    x0s[3, i23] += 0.05
    fits = {}
    for device, cd in cds.items():
        value_fn, _ = cd.build_objective(asimov, "llh")
        t0 = time.perf_counter()
        x, fun, nit = fit_batch_on_device(
            value_fn.raw_with_data, x0s, *cd._current_bounds(), data,
            max_steps=BATCH_FIT_STEPS, gtol=BATCH_FIT_GTOL, device=device)
        fits[device] = (x.cpu().numpy(), fun.cpu().numpy(),
                        nit.cpu().numpy())
        print(f"float64 batched fit, {BATCH_FIT_LANES} lanes, {label},"
              f" {device}: nit {fits[device][2].tolist()}, fun"
              f" {fits[device][1].tolist()}; wall"
              f" {time.perf_counter() - t0:.2f} s (with the capture) [{smi}]")
    solo_nit, solo_dx = [], 0.0
    t0 = time.perf_counter()
    for b in range(BATCH_FIT_LANES):
        value_fn, _ = cds["cuda"].build_objective(data[b], "llh")
        fit = minimize_on_device(value_fn.raw, x0s[b],
                                 *cds["cuda"]._current_bounds(),
                                 max_steps=BATCH_FIT_STEPS,
                                 gtol=BATCH_FIT_GTOL, device="cuda")
        solo_nit.append(fit["nit"])
        solo_dx = max(solo_dx, float(np.abs(fit["x"]
                                            - fits["cuda"][0][b]).max()))
    cpu_dx = float(np.abs(fits["cuda"][0] - fits["cpu"][0]).max())
    print(f"float64 batched fit ({label}) on the card vs each lane's solo"
          f" card fit: nit {fits['cuda'][2].tolist()} vs {solo_nit}, max"
          f" |dx| {solo_dx:.3e} (bound {BATCH_SOLO_X_ATOL:g}); solo fits"
          f" {time.perf_counter() - t0:.2f} s [{smi}]")
    print(f"float64 batched fit ({label}), card vs CPU: nit"
          f" {fits['cuda'][2].tolist()} vs {fits['cpu'][2].tolist()}, max"
          f" |dx| {cpu_dx:.3e} (bound {BATCH_CPU_X_ATOL:g}) [{smi}]")
    if require_spread:
        check(len(set(solo_nit)) > 1,
              f"the lanes all stopped at iteration {solo_nit[0]}")
    check(fits["cuda"][2].tolist() == solo_nit,
          f"{label}: a batched lane took other iterations than its solo fit")
    check(solo_dx <= BATCH_SOLO_X_ATOL,
          f"{label}: a batched lane's best fit is off its solo fit")
    check(np.array_equal(fits["cuda"][2], fits["cpu"][2]),
          f"{label}: card and CPU batched fits took different iterations")
    check(cpu_dx <= BATCH_CPU_X_ATOL, f"{label}: card and CPU batched fits"
          " differ")


def release_hypothesis(device):
    """The released counts (a MapSet) and DistributionMaker([daemon
    neutrinos, muons]) on `device`, at full width."""
    from pisa_tpu_torch.core.distribution_maker import DistributionMaker
    from pisa_tpu_torch.core.pipeline import Pipeline

    data = Pipeline(DATA_CFG, device=device).get_outputs()
    return data, DistributionMaker([DAEMON_CFG, MUON_CFG], device=device)


def release_point(cd, seed=8):
    """The release objective's value_and_grad point: the nominal rescaled
    values clipped to [0.15, 0.85] plus a seeded offset in [-0.05, 0.05]."""
    import numpy as np

    v0 = np.clip(cd.current_rescaled_values(), 0.15, 0.85)
    rng = np.random.RandomState(seed)
    return np.clip(v0 + rng.uniform(-0.05, 0.05, v0.size), 0.1, 0.9)


def release_fp64(smi):
    """float64, the release's fit at full width: value_and_grad of mod_chi2
    of the daemon neutrinos plus muons against the released counts, on the
    CPU (eager) and on the card (one captured program over both pipelines,
    the neutrinos stacked with the flux per event, so no rate deferral),
    held to VG_FP64. Returns the CPU's point, value and gradient (for the
    float32 check in the main process)."""
    import numpy as np
    import torch

    from pisa_tpu_torch.analysis.gradient import CompiledDistribution

    results = {}
    for device in ("cpu", "cuda"):
        t0 = time.perf_counter()
        data, dm = release_hypothesis(device)
        cd = CompiledDistribution(dm)
        _, vg = cd.build_objective(data, "mod_chi2")
        setup = time.perf_counter() - t0
        check(len(cd.free_names) == RELEASE_FREE
              and cd.free_names[-1] == "atm_muon_scale",
              f"release free params {cd.free_names}")
        check(cd.templates[0].stacked and not cd.templates[0].rate_deferred
              and not cd.templates[1].stacked,
              "the release's neutrinos do not run stacked with the flux per"
              " event, or the muons not per container")
        v = release_point(cd)
        t0 = time.perf_counter()
        value, grad = vg(v)
        value, grad = float(value), grad.cpu().numpy()
        wall = time.perf_counter() - t0
        results[device] = (v, value, grad, cd.free_names)
        print(f"float64 release objective (daemon neutrinos + muons vs the"
              f" released counts), {device}: value {value!r}, set-up and"
              f" capture {setup:.2f} s, value_and_grad {wall:.3f} s [{smi}]")
        del cd, dm
        if device == "cuda":
            torch.cuda.synchronize()
    v, value, grad, names = results["cpu"]
    check(results["cuda"][3] == names, "card and CPU free params differ")
    check(np.array_equal(results["cuda"][0], v), "card and CPU points differ")
    rel = abs(results["cuda"][1] - value) / abs(value)
    mism = grad_mismatch(results["cuda"][2], grad, VG_FP64["grad_rtol"],
                         VG_FP64["grad_atol"])
    print(f"float64 release value_and_grad, card vs CPU: value {rel:.3e}"
          f" relative (bound {VG_FP64['value']:g}), gradient at"
          f" {mism:.3e} of its bound (rtol {VG_FP64['grad_rtol']:g}, atol"
          f" {VG_FP64['grad_atol']:g} max|g|) [{smi}]")
    check(rel <= VG_FP64["value"], "release value: card vs CPU")
    check(mism <= 1.0, "release gradient: card vs CPU")
    return {"release|v": v, "release|value": np.asarray(value),
            "release|grad": grad, "release|names": np.asarray(names)}


# -- the float64 child ---------------------------------------------------------
def reference_worker(path):
    """float64: the CPU reference and the card run at every template point,
    then the gradient phase (gradient_worker); saved to `path` (npz) with the
    card's launch counts."""
    import numpy as np
    import torch

    from pisa_tpu_torch import FTYPE_NAME, ureg
    from pisa_tpu_torch.core.pipeline import Pipeline
    from pisa_tpu_torch.ops.osc import chain

    check(FTYPE_NAME == "fp64", f"reference worker runs {FTYPE_NAME}")
    t0 = time.perf_counter()
    cpu_pipeline = Pipeline(CFG, device="cpu")
    cpu_out, _ = run_points(cpu_pipeline, ureg, chain)
    t_cpu = time.perf_counter() - t0
    gpu_pipeline = Pipeline(CFG, device="cuda")
    chain.launch_count = 0
    gpu_out, launches = run_points(gpu_pipeline, ureg, chain)
    torch.cuda.synchronize()
    arrays = {"cpu_seconds": np.asarray(t_cpu)}
    for label, changes, osc_changed in param_points(ureg):
        check(launches[label] == (2 if osc_changed else 0),
              f"float64 {label}: {launches[label]} kernel launches")
        for tag, out in (("cpu", cpu_out), ("gpu", gpu_out)):
            hists, errs = out[label]
            for name in hists:
                arrays[f"{tag}|{label}|w|{name}"] = hists[name]
                arrays[f"{tag}|{label}|e|{name}"] = errs[name]
        arrays[f"launches|{label}"] = np.asarray(launches[label])
    arrays.update(gradient_worker(cpu_pipeline, gpu_pipeline, chain))
    smi = card_line()
    t0 = time.perf_counter()
    template_fp64(gpu_pipeline, smi)
    print(f"float64 template phase: {time.perf_counter() - t0:.1f} s")
    del cpu_pipeline, gpu_pipeline
    t0 = time.perf_counter()
    lbfgs_parity_fp64(smi)
    print(f"float64 L-BFGS parity phase: {time.perf_counter() - t0:.1f} s"
          f" [{smi}]")
    t0 = time.perf_counter()
    batch_parity_fp64(smi)
    print(f"float64 batched-fit parity phase: {time.perf_counter() - t0:.1f}"
          f" s [{smi}]")
    t0 = time.perf_counter()
    arrays.update(release_fp64(smi))
    print(f"float64 release phase: {time.perf_counter() - t0:.1f} s [{smi}]")
    np.savez(path, **arrays)


def release_worker(path):
    """float64: the release phase alone (``--release-only``)."""
    import numpy as np

    from pisa_tpu_torch import FTYPE_NAME

    check(FTYPE_NAME == "fp64", f"release worker runs {FTYPE_NAME}")
    smi = card_line()
    t0 = time.perf_counter()
    arrays = release_fp64(smi)
    print(f"float64 release phase: {time.perf_counter() - t0:.1f} s [{smi}]")
    np.savez(path, **arrays)


# -- the rest of the analysis layer, float64 (its own child) ---------------------
def small_grid_variance(data, seed=3):
    """A nonzero data variance for the MC-uncertainty metrics (the JAX
    package passes the data's variance to them; at zero they fall to their
    Poisson limit): a seeded fraction of each bin's count plus one."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return rng.uniform(0.2, 1.0, data.shape) * (data + 1.0)


def metrics_fp64(smi):
    """float64, the 20x20-grid flagship on the CPU and on the card: the
    value_and_grad of each MC-uncertainty metric through
    CompiledDistribution with a nonzero data variance, and of mcllh_eff
    through CompiledTemplate.build_objective(sum_maps=True), at the
    gradient point; the card (captured) against the CPU (eager) within
    VG_FP64."""
    import numpy as np
    import torch

    from pisa_tpu_torch.analysis.gradient import CompiledDistribution
    from pisa_tpu_torch.core.pipeline import Pipeline

    sides = {}
    for device in ("cpu", "cuda"):
        pipeline = Pipeline(small_grid_config(), device=device)
        sides[device] = (pipeline, CompiledDistribution(pipeline),
                         pipeline.compile())
    cd_cpu, ct_cpu = sides["cpu"][1:]
    v = gradient_point(ct_cpu)
    nominal = ct_cpu.current_rescaled_values()
    data = cd_cpu.sum_hist(nominal)
    var = small_grid_variance(data)
    maps = ct_cpu.get_outputs(nominal)
    objectives = [(m, lambda cd, ct, m=m: cd.build_objective(
        data, m, data_variance=var)[1]) for m in MC_METRICS]
    objectives.append(("mcllh_eff, sum_maps", lambda cd, ct: ct.build_objective(
        maps, "mcllh_eff", sum_maps=True)[1]))
    for label, build in objectives:
        results = {}
        for device, (_, cd, ct) in sides.items():
            vg = build(cd, ct)
            value, grad = vg(v)
            results[device] = (float(value), grad.cpu().numpy())
        (want, want_g), (got, got_g) = results["cpu"], results["cuda"]
        rel = abs(got - want) / abs(want)
        mism = grad_mismatch(got_g, want_g, VG_FP64["grad_rtol"],
                             VG_FP64["grad_atol"])
        print(f"float64 {label}, 20x20-grid flagship, card vs CPU: value"
              f" {got!r} vs {want!r} ({rel:.3e} relative, bound"
              f" {VG_FP64['value']:g}); gradient at {mism:.3e} of its bound"
              f" [{smi}]")
        check(np.isfinite(got) and np.all(np.isfinite(got_g)),
              f"{label}: not finite on the card")
        check(rel <= VG_FP64["value"], f"{label}: card value vs CPU")
        check(mism <= 1.0, f"{label}: card gradient vs CPU")
    torch.cuda.synchronize()


def generalized_fp64(smi):
    """float64, the generalized Poisson-gamma likelihood's toy pipeline
    (GEN_CFG) with n_events set through its param to GEN_EVENTS, on the CPU
    and on the card: the template's histograms, alphas and betas, and the
    captured value_and_grad of generalized_poisson_llh (at the nominal
    values + 0.05 rescaled) against the CPU; k_max and the objective's
    times. Then the mixture's recursion alone at the data's largest count
    (the length the JAX package would take) on the card, forward and
    backward, timed."""
    import numpy as np
    import torch

    from pisa_tpu_torch import ureg
    from pisa_tpu_torch.core.pipeline import Pipeline
    from pisa_tpu_torch.utils.llh_defs.poisson import (
        generalized_pg_log_mixture,
    )

    templates = {}
    for device in ("cpu", "cuda"):
        t0 = time.perf_counter()
        pipeline = Pipeline(GEN_CFG, device=device)
        pipeline.params["n_events"].value = GEN_EVENTS * ureg.dimensionless
        pipeline.setup()
        templates[device] = pipeline.compile()
        print(f"generalized: {GEN_EVENTS} toy events, set-up on {device}"
              f" {time.perf_counter() - t0:.2f} s")
    ct_cpu, ct = templates["cpu"], templates["cuda"]
    v0 = ct_cpu.current_rescaled_values()
    v = np.clip(v0 + 0.05, 0.0, 1.0)
    out_cpu, out = ct_cpu(v), ct(v)
    for key in ("hist", "llh_alphas", "llh_betas", "n_mc_events"):
        for name in out_cpu[key]:
            err = max_rel(out_cpu[key][name].numpy(),
                          out[key][name].cpu().numpy())
            print(f"float64 generalized {key} {name}, card vs CPU: {err:.3e}"
                  f" relative (bound {TEMPLATE_RTOL['float64']:g})")
            check(err <= TEMPLATE_RTOL["float64"], f"generalized {key}")
    data = {n: h.numpy() for n, h in ct_cpu(v0)["hist"].items()}
    total = sum(data.values())
    k_max = ct._mixture_k_max(total)
    results = {}
    for device, tpl in templates.items():
        t0 = time.perf_counter()
        value_fn, vg = tpl.build_objective(data, "generalized_poisson_llh")
        built = time.perf_counter() - t0
        value, grad = vg(v)
        results[device] = (float(value), grad.cpu().numpy(), built, vg)
    (want, want_g, cpu_built, cpu_vg), (got, got_g, built, vg) = (
        results["cpu"], results["cuda"])
    rel = abs(got - want) / abs(want)
    mism = grad_mismatch(got_g, want_g, VG_FP64["grad_rtol"],
                         VG_FP64["grad_atol"])
    wall, wall_min = median_wall(lambda: read_back(vg(v)), 10)
    cpu_wall = median_wall(lambda: read_back(cpu_vg(v)), 3)[0]
    print(f"float64 generalized_poisson_llh, {GEN_EVENTS} events, card vs"
          f" CPU: value {got!r} ({rel:.3e} relative, bound"
          f" {VG_FP64['value']:g}), gradient {got_g} at {mism:.3e} of its"
          f" bound; k_max {k_max} (the bins that use the mixture; the"
          f" data's largest count {int(np.ceil(total.max()))}); captured"
          f" value_and_grad {wall * 1e3:.3f} ms median of 10 (min"
          f" {wall_min * 1e3:.3f}; build and capture {built:.2f} s), CPU"
          f" {cpu_wall * 1e3:.1f} ms [{smi}]")
    check(np.isfinite(got) and np.all(np.isfinite(got_g)),
          "generalized: not finite on the card")
    check(rel <= VG_FP64["value"], "generalized: card value vs CPU")
    check(mism <= 1.0, "generalized: card gradient vs CPU")
    generalized_c_route(ct, v, total, k_max, smi)

    # the recursion alone, at the length the JAX package takes here
    k_full = int(np.ceil(total.max()))
    out = ct(v)
    alphas = torch.stack([out["llh_alphas"][n] for n in data]).T.contiguous()
    betas = torch.stack([out["llh_betas"][n] for n in data]).T.contiguous()
    counts = torch.as_tensor(np.minimum(total, k_full), device="cuda").to(
        torch.int64)
    for k in (k_max, 256, k_full):
        a = alphas.clone().requires_grad_(True)

        def run(a=a, k=k):
            lp = generalized_pg_log_mixture(counts, a, betas, k_max=k)
            (g,) = torch.autograd.grad(lp.sum(), a)
            return g

        run()
        mix_wall, _ = median_wall(run, 3)
        with torch.no_grad():
            fwd_wall, _ = median_wall(
                lambda k=k: generalized_pg_log_mixture(counts, alphas, betas,
                                                       k_max=k), 3)
        print(f"float64 generalized mixture recursion alone, {counts.numel()}"
              f" bins x {alphas.shape[1]} sources, eager on the card: k_max"
              f" {k}: forward {fwd_wall * 1e3:.2f} ms, forward and backward"
              f" {mix_wall * 1e3:.2f} ms [{smi}]")


def generalized_c_route(ct, v, total, k_max, smi):
    """float64: generalized_poisson_llh(use_c=True), the host C library
    built from the port's copy of poisson_gamma.c with this machine's
    compiler, against the torch route on the card, on the generalized toy's
    bins (the card template's outputs at `v`, the counts `total`), within
    C_ROUTE_TOL."""
    import shutil

    import numpy as np
    import torch

    from pisa_tpu_torch.utils import stats
    from pisa_tpu_torch.utils.llh_defs import native
    from pisa_tpu_torch.utils.llh_defs.poisson import (
        generalized_pg_log_mixture,
        mixture_bins,
    )

    cc = os.environ.get("CC", "cc")
    version = subprocess.run([cc, "--version"], capture_output=True,
                             text=True).stdout.splitlines()
    t0 = time.perf_counter()
    lib = native.library()
    build_s = time.perf_counter() - t0
    out = ct(v)
    names = list(out["hist"])
    expected = {"weights": torch.stack([out["hist"][n] for n in names])}
    for key in ("llh_alphas", "llh_betas", "n_mc_events"):
        expected[key] = torch.stack([out[key][n] for n in names])
    actual = torch.as_tensor(total, device="cuda")
    t0 = time.perf_counter()
    via_c = stats.generalized_poisson_llh(actual, expected, use_c=True)
    torch.cuda.synchronize()
    c_s = time.perf_counter() - t0
    via_torch = stats.generalized_poisson_llh(actual, expected, k_max=k_max)
    got, want = via_c.cpu().numpy(), via_torch.cpu().numpy()
    excess = np.abs(got - want) - (C_ROUTE_TOL["atol"]
                                   + C_ROUTE_TOL["rtol"] * np.abs(want))
    # none of the toy's bins takes the mixture (every source holds more than
    # 100 MC events there, and at its alphas of ~2,000 the recursion
    # overflows in both routes), so the mixture itself is held on the
    # reference test's inputs (tests/test_generalized_llh.py): 40 bins of 3
    # sources, k below 30, one NaN alpha and one zero beta (masked)
    rng = np.random.RandomState(4)
    counts = rng.randint(0, 30, 40)
    alphas = rng.uniform(0.5, 20.0, (40, 3))
    betas = rng.uniform(0.2, 5.0, (40, 3))
    alphas[3, 1] = np.nan
    betas[7, 2] = 0.0
    k_full = int(counts.max())
    t0 = time.perf_counter()
    mix_c = native.pg_log_mixture_c(counts, alphas, betas)
    mix_s = time.perf_counter() - t0
    mix_torch = generalized_pg_log_mixture(
        *(torch.as_tensor(a, device="cuda") for a in (counts, alphas, betas)),
        k_max=k_full).cpu().numpy()
    mix_excess = np.abs(mix_c - mix_torch) - (
        C_ROUTE_TOL["atol"] + C_ROUTE_TOL["rtol"] * np.abs(mix_torch))
    print(f"float64 generalized_poisson_llh(use_c=True), {got.size} bins:"
          f" the C library ({os.path.relpath(lib._name, ROOT)}, built with"
          f" {shutil.which(cc) or cc}: {version[0] if version else '?'}) in"
          f" {build_s:.2f} s; one call {c_s * 1e3:.2f} ms on the host;"
          f" against the torch route on the card max |difference|"
          f" {np.abs(got - want).max():.3e} (rtol {C_ROUTE_TOL['rtol']:g},"
          f" atol {C_ROUTE_TOL['atol']:g}); result on {via_c.device};"
          f" {int(mixture_bins(expected['n_mc_events']).sum())} bins take the"
          f" mixture there. The mixture on the reference test's {mix_c.size}"
          f" bins (k up to {k_full}): C {mix_s * 1e3:.2f} ms on the host, max"
          f" |C - torch on the card| {np.abs(mix_c - mix_torch).max():.3e}"
          f" [{smi}]")
    check(via_c.device.type == "cuda" and np.all(np.isfinite(got))
          and np.all(excess <= 0), "the C route is off the torch route")
    check(np.all(np.isfinite(mix_c)) and np.all(mix_excess <= 0),
          "the C library's mixture is off the torch recursion")


def fisher_fp64(smi):
    """float64, the 20x20-grid flagship: get_fisher_matrix (priors on) and
    calculate_pulls (the data at the gradient point, the template at
    nominal) on the card against the CPU, relative to the matrix's largest
    entry and per pull."""
    import numpy as np

    from pisa_tpu_torch.analysis.fisher import (
        calculate_pulls,
        get_fisher_matrix,
    )
    from pisa_tpu_torch.core.pipeline import Pipeline

    results = {}
    for device in ("cpu", "cuda"):
        ct = Pipeline(small_grid_config(), device=device).compile()
        shifted = {n: h.cpu().numpy()
                   for n, h in ct(gradient_point(ct))["hist"].items()}
        t0 = time.perf_counter()
        fm = get_fisher_matrix(ct)
        wall = time.perf_counter() - t0
        results[device] = (fm, calculate_pulls(ct, shifted), wall)
    (fm_cpu, pulls_cpu, cpu_wall), (fm, pulls, wall) = (results["cpu"],
                                                        results["cuda"])
    err = rel_max(fm.matrix, fm_cpu.matrix)
    # the matrix's condition (~6e9) amplifies round-off in the pulls: they
    # are compared in units of each param's Fisher sigma
    pull_err = max(abs(pulls[n] - pulls_cpu[n]) / fm_cpu.get_sigma(n)
                   for n in pulls_cpu)
    print(f"float64 Fisher matrix, 20x20-grid flagship ({len(fm.parameters)}"
          f" params, condition {np.linalg.cond(fm_cpu.matrix):.3g}), card vs"
          f" CPU: {err:.3e} of the largest entry (bound {FISHER_FP64:g});"
          f" pulls within {pull_err:.3e} sigma (bound {FISHER_FP64:g}); wall"
          f" {wall:.2f} s on the card, {cpu_wall:.2f} s on the CPU [{smi}]")
    check(np.all(np.isfinite(fm.matrix)), "Fisher matrix not finite")
    check(err <= FISHER_FP64, "Fisher matrix: card vs CPU")
    check(pull_err <= FISHER_FP64, "pulls: card vs CPU")


def analysis_worker():
    """float64: the rest of the analysis layer, card against CPU."""
    from pisa_tpu_torch import FTYPE_NAME

    check(FTYPE_NAME == "fp64", f"analysis worker runs {FTYPE_NAME}")
    smi = card_line()
    for label, phase in (("metrics", metrics_fp64),
                         ("generalized", generalized_fp64),
                         ("fisher", fisher_fp64)):
        t0 = time.perf_counter()
        phase(smi)
        print(f"float64 {label} phase: {time.perf_counter() - t0:.1f} s"
              f" [{smi}]")


# -- the main (float32) process ------------------------------------------------
def run_children(children):
    """Runs the float64 child processes `children` ([(label, arguments of
    this script)]) at once, each with its output in a file of its own;
    when all have ended, prints each one's output and wall in turn, and
    fails if one failed. Together their OpenMP threads outnumber the
    host's cores, so an idle thread sleeps (OMP_WAIT_POLICY=PASSIVE, unless
    the caller set it) rather than spin on a core another child needs."""
    started = []
    env = dict(os.environ, PISA_TPU_FTYPE="fp64")
    env.setdefault("OMP_WAIT_POLICY", "PASSIVE")
    for label, args in children:
        out = tempfile.TemporaryFile(mode="w+")
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *args],
            env=env, stdout=out, stderr=subprocess.STDOUT, text=True)
        started.append((label, proc, out, time.perf_counter()))
    walls = {}
    while len(walls) < len(started):
        for label, proc, _, t0 in started:
            if label not in walls and proc.poll() is not None:
                walls[label] = time.perf_counter() - t0
        time.sleep(0.2)
    failed = []
    for label, proc, out, _ in started:
        out.seek(0)
        sys.stdout.write(out.read())
        out.close()
        print(f"float64 child ({label}): {walls[label]:.1f} s, beside the"
              f" others{'' if proc.returncode == 0 else f'; exit code {proc.returncode}'}")
        if proc.returncode != 0:
            failed.append(label)
    check(not failed, f"float64 children failed: {failed}")


def card_line():
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def device_lines():
    import torch

    smi = card_line()
    print(f"nvidia-smi: {smi}")
    print(f"torch.cuda.get_device_name(0): {torch.cuda.get_device_name(0)}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda},"
          f" python {sys.version.split()[0]}")
    return smi


def build_kernel(chain):
    """Build (or load) the kernel libraries, one nvcc for each, all started
    together (the chain kernels' three parts of osc_chain.cu and
    herm4_eig.cu); print the compiler's report."""
    from pisa_tpu_torch.utils.cuda_build import build_libraries

    from pisa_tpu_torch.ops import kde
    from pisa_tpu_torch.ops.osc import herm4
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(log):
        specs = {name: ([chain._CSRC], [flag])
                 for name, flag in chain._PARTS.items()}
        specs["herm4_eig"] = ([herm4._CSRC], [])
        specs["kde_gauss"] = ([kde._CSRC], [])
        build_libraries(specs)
        chain.kernel_library()
        herm4.kernel_library()
        kde.kernel_library()
    print(f"kernel build/load: {time.perf_counter() - t0:.1f} s"
          f" (from {KERNEL_SOURCE}, {HERM4_SOURCE} and {KDE_SOURCE},"
          " sm_90a)")
    for line in log.getvalue().splitlines():
        print(f"  {line}")


def flagship_geometry(dtype, cfg=CFG):
    """The kernel's prepared geometry on the prob3 calc grid of the config
    `cfg` (by default the flagship's 200x200 grid) with its PREM-12 Earth
    model, on the card."""
    from pisa_tpu_torch.config.parser import parse_pipeline_config
    from pisa_tpu_torch.ops.osc.chain import prepare_chain_geometry
    from pisa_tpu_torch.ops.osc.layers import Layers

    config = parse_pipeline_config(cfg)
    settings = config[("osc", "prob3")]
    selector = settings["params"]
    selector.select_params(config["pipeline"]["param_selections"])
    params = {p.name: p for p in selector.params}
    layers = Layers(
        params["earth_model"].value,
        params["detector_depth"].m_as("km"),
        params["prop_height"].m_as("km"),
    )
    layers.setElecFrac(*(params[n].m_as("dimensionless")
                         for n in ("YeI", "YeO", "YeM")))
    binning = settings["calc_mode"]
    grid = binning.meshgrid(entity="weighted_centers", attach_units=False)
    energy = grid[binning.index("true_energy")].ravel()
    layers.calcLayers(grid[binning.index("true_coszen")].ravel())
    shape = (energy.size, layers.max_layers)
    return prepare_chain_geometry(
        energy, layers.density.reshape(shape),
        layers.distance.reshape(shape), dtype=dtype, device="cuda",
    ), params


def flagship_thetas(params, count=4):
    """Nominal NuFIT and `count` - 1 seeded random theta (the same for every
    dtype; the first 4 the same for every count)."""
    import numpy as np

    nominal = [
        params["theta12"].m_as("rad"), params["theta13"].m_as("rad"),
        params["theta23"].m_as("rad"), params["deltacp"].m_as("rad"),
        params["deltam21"].m_as("eV**2"), params["deltam31"].m_as("eV**2"),
    ]
    rng = np.random.RandomState(20261016)
    return [nominal] + [
        [np.radians(rng.uniform(31, 36)), np.radians(rng.uniform(8, 9)),
         np.radians(rng.uniform(38, 52)), np.radians(rng.uniform(0, 360)),
         rng.uniform(7e-5, 8e-5),
         rng.choice([-1, 1]) * rng.uniform(2.3e-3, 2.7e-3)]
        for _ in range(count - 1)
    ]


def pack_and_directions(chain, theta, nubar, dtype):
    """The pack on the card and the 6 columns of its Jacobian in theta (the
    directions the gradient's tangents run along), (6, 57)."""
    import torch

    th = torch.tensor(theta, dtype=torch.float64)
    jac = torch.func.jacfwd(lambda t: chain.theta_to_pvec(t, nubar))(th)
    return (chain.theta_to_pvec(th, nubar).to("cuda", dtype),
            jac.T.contiguous().to("cuda", dtype))


def kernel_bound(chain, geom, k, with_primal, lanes=1):
    """Least time of one launch over `lanes` lanes on the card: operations
    (chain.chain_operations, counted for this geometry's layer steps, each
    lane's) over the peak rate of the dtype, or bytes (inputs read once:
    energy, bounds and the slab entries the chains reach, shared by the
    lanes, and each lane's pack and directions; each lane's outputs written
    once) over the memory rate; the larger, and which it is."""
    dname = str(geom["e"].dtype).split(".")[-1]
    size = geom["e"].element_size()
    n = geom["e"].shape[0]
    steps = int((geom["dist"] > 0).sum())
    slab_entries = int(geom["nl"].long().sum())
    per_point, per_step = chain.chain_operations(k, lanes)
    ops = n * per_point + steps * per_step
    outputs = 6 * n * (k + (1 if with_primal else 0)) * lanes
    nbytes = size * (n + 2 * slab_entries + chain.N_PACK * (1 + k) * lanes
                     + outputs) + 4 * n
    t_ops = ops / PEAK_FLOPS[dname] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}


def kernel_vs_plain(chain):
    """Primal kernel vs plain version on the card: flagship geometry, nu and
    nubar, nominal NuFIT and 3 seeded random theta, in float64 and float32.
    Then the kernel's device-only and host-inclusive times, the plain
    version's, and the kernel's resources. Returns the summary per dtype."""
    import torch

    summary = {}
    exact = {}  # float64 plain results, to show the float32 kernel's error
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        geom, params = flagship_geometry(dtype)
        thetas = flagship_thetas(params)
        args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
        tiles = geom["tiles"]
        worst = vs_exact = 0.0
        for i, theta in enumerate(thetas):
            for nubar in (1, -1):
                pvec = chain.theta_to_pvec(theta, nubar).to("cuda", dtype)
                got = chain.chain_probs(pvec, *args, tiles)
                ref = chain.chain_probs_reference(pvec, *args)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()),
                      f"{dname}: kernel output not finite")
                err = float((got - ref).abs().max())
                worst = max(worst, err)
                if dtype == torch.float64:
                    exact[i, nubar] = ref
                else:
                    vs_exact = max(vs_exact, float(
                        (got.double() - exact[i, nubar]).abs().max()))
        n = geom["e"].shape[0]
        print(f"kernel vs plain, {dname}, N={n}, L={geom['dens'].shape[0]},"
              f" mean chain {float(geom['nl'].double().mean()):.3f},"
              f" max {int(geom['nl'].max())}: max|kernel-plain| = {worst:.3e}"
              f" (bound {KERNEL_ATOL[dname]:g}, 4 theta x 2 signs)")
        check(worst <= KERNEL_ATOL[dname],
              f"{dname}: kernel disagrees with plain version by {worst}")
        if dtype == torch.float32:
            print(f"  float32 kernel vs float64 plain: max abs {vs_exact:.3e}"
                  " (the float32 algorithm's own error)")

        pvec = chain.theta_to_pvec(thetas[0], 1).to("cuda", dtype)
        run = lambda: chain.chain_probs(pvec, *args, tiles)  # noqa: E731
        device_ms = graph_time(run)
        host_ms = cuda_time(run, 200)
        plain_ms = cuda_time(lambda: chain.chain_probs_reference(pvec, *args),
                             10)
        bound = kernel_bound(chain, geom, 0, True)
        print(f"time, osc_chain {dname}, N={n}, {tile_line(tiles)}: kernel"
              f" {device_ms:.5f} ms device-only (CUDA graph), {host_ms:.5f} ms"
              f" with the host's enqueue (CUDA events), plain PyTorch"
              f" {plain_ms:.4f} ms; bound {bound['bound_ms']:.5f} ms by"
              f" {bound['bound_by']} ({bound['ops']} operations,"
              f" {bound['bytes']} bytes)")
        summary[dname] = {"max_abs_err": worst, "ms": device_ms,
                          "host_ms": host_ms, "plain_ms": plain_ms, **bound,
                          **resources(chain, "osc_chain", dtype)}
    return summary


def tangent_vs_plain(chain):
    """Tangent kernel vs plain version (forward-mode derivative of the plain
    primal) on the card: flagship geometry, nu and nubar, nominal and 3
    seeded theta, all 6 pack-Jacobian directions, float64 and float32. The
    error of a direction is max|kernel - plain| over its (2, 3, N) output
    relative to that output's max|plain|. Then the kernel's times and the
    plain version's."""
    import torch

    summary = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        geom, params = flagship_geometry(dtype)
        thetas = flagship_thetas(params)
        args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
        tiles = geom["tiles"]
        worst_rel = worst_abs = 0.0
        for theta in thetas:
            for nubar in (1, -1):
                pvec, dirs = pack_and_directions(chain, theta, nubar, dtype)
                for d in dirs:
                    got = chain.chain_tangent(pvec, d, *args, tiles)
                    ref = chain.chain_tangent_reference(pvec, d, *args)
                    torch.cuda.synchronize()
                    check(bool(torch.isfinite(got).all()),
                          f"{dname}: tangent kernel output not finite")
                    err = float((got - ref).abs().max())
                    worst_abs = max(worst_abs, err)
                    worst_rel = max(worst_rel,
                                    err / float(ref.abs().max()))
        print(f"tangent kernel vs plain, {dname}: max rel {worst_rel:.3e}"
              f" (bound {TANGENT_RTOL[dname]:g}; 4 theta x 2 signs x 6"
              f" directions), max abs {worst_abs:.3e}")
        check(worst_rel <= TANGENT_RTOL[dname],
              f"{dname}: tangent kernel disagrees with plain by {worst_rel}")
        pvec, dirs = pack_and_directions(chain, thetas[0], 1, dtype)
        d = dirs[2].contiguous()  # theta23
        run = lambda: chain.chain_tangent(pvec, d, *args, tiles)  # noqa: E731
        device_ms = graph_time(run)
        host_ms = cuda_time(run, 200)
        plain_ms = cuda_time(
            lambda: chain.chain_tangent_reference(pvec, d, *args), 5)
        bound = kernel_bound(chain, geom, 1, False)
        print(f"time, osc_chain_tangent {dname}, {tile_line(tiles)}: kernel"
              f" {device_ms:.5f} ms device-only (CUDA graph), {host_ms:.5f}"
              f" ms with enqueue; plain PyTorch {plain_ms:.4f} ms; bound"
              f" {bound['bound_ms']:.5f} ms by {bound['bound_by']}"
              f" ({bound['ops']} operations, {bound['bytes']} bytes)")
        summary[dname] = {
            "max_abs_err": worst_abs, "max_rel_err": worst_rel,
            "ms": device_ms, "host_ms": host_ms, "plain_ms": plain_ms,
            **bound, **resources(chain, "osc_chain_tangent", dtype)}
    return summary


def multitangent_vs_plain(chain):
    """Multitangent kernel at K = 3 (the flagship's free theta13, theta23,
    dm31), K = 1 and K = 6 on the card against its plain version and
    against the primal kernel and K launches of the tangent kernel:
    flagship geometry, nu and nubar, nominal and seeded theta (4 at K = 3, 2
    at K = 1 and 6), float64 and float32. Then, at K = 3 and K = 6, its
    device-only and host-inclusive times beside K tangent launches', and
    every instance's resources. Returns the K = 3 summary per dtype."""
    import torch

    summary = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        geom, params = flagship_geometry(dtype)
        thetas = flagship_thetas(params)
        args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
        tiles = geom["tiles"]
        for k in (3, 1, 6):
            pick = list(FREE_THETA) if k == 3 else list(range(k))
            errs = {"plain_p": 0.0, "plain_t": 0.0, "plain_t_abs": 0.0,
                    "kern_p": 0.0, "kern_t": 0.0}
            for theta in thetas if k == 3 else thetas[:2]:
                for nubar in (1, -1):
                    pvec, dirs = pack_and_directions(chain, theta, nubar,
                                                     dtype)
                    dpvecs = dirs[pick].contiguous()
                    out, dout = chain.chain_multitangent(pvec, dpvecs, *args,
                                                         tiles)
                    ref_p, ref_t = chain.chain_multitangent_reference(
                        pvec, dpvecs, *args)
                    kern_p = chain.chain_probs(pvec, *args, tiles)
                    kern_t = torch.stack(
                        [chain.chain_tangent(pvec, d, *args, tiles)
                         for d in dpvecs])
                    torch.cuda.synchronize()
                    check(bool(torch.isfinite(out).all())
                          and bool(torch.isfinite(dout).all()),
                          f"{dname}: multitangent kernel output not finite")
                    scale = ref_t.abs().amax(dim=(1, 2, 3), keepdim=True)
                    for key, value in (
                        ("plain_p", (out - ref_p).abs().max()),
                        ("plain_t", ((dout - ref_t).abs() / scale).max()),
                        ("plain_t_abs", (dout - ref_t).abs().max()),
                        ("kern_p", (out - kern_p).abs().max()),
                        ("kern_t", ((dout - kern_t).abs() / scale).max()),
                    ):
                        errs[key] = max(errs[key], float(value))
            print(f"multitangent kernel (K={k}), {dname}: primal vs plain"
                  f" {errs['plain_p']:.3e}, vs primal kernel"
                  f" {errs['kern_p']:.3e} (bound {MULTI_PRIMAL_ATOL[dname]:g}"
                  f" abs); tangents vs plain {errs['plain_t']:.3e}, vs"
                  f" tangent kernel {errs['kern_t']:.3e} (bound"
                  f" {TANGENT_RTOL[dname]:g} rel);"
                  f" {4 if k == 3 else 2} theta x 2 signs")
            check(max(errs["plain_p"], errs["kern_p"])
                  <= MULTI_PRIMAL_ATOL[dname],
                  f"{dname}: K={k} multitangent primal off by {errs}")
            check(max(errs["plain_t"], errs["kern_t"]) <= TANGENT_RTOL[dname],
                  f"{dname}: K={k} multitangent tangents off by {errs}")
            if k == 1:
                continue
            pvec, dirs = pack_and_directions(chain, thetas[0], 1, dtype)
            dpvecs = dirs[pick].contiguous()
            run = lambda: chain.chain_multitangent(  # noqa: E731
                pvec, dpvecs, *args, tiles)
            separate = lambda: [  # noqa: E731
                chain.chain_tangent(pvec, d, *args, tiles) for d in dpvecs]
            # in turns: K tangents, multitangent, multitangent, K tangents
            turns = {"multi": [], "separate": []}
            for label in ("separate", "multi", "multi", "separate"):
                fn = run if label == "multi" else separate
                turns[label].append((graph_time(fn), cuda_time(fn, 200)))
            device_ms, host_ms = (min(t[i] for t in turns["multi"])
                                  for i in (0, 1))
            sep_ms, sep_host_ms = (min(t[i] for t in turns["separate"])
                                   for i in (0, 1))
            plain_ms = cuda_time(
                lambda: chain.chain_multitangent_reference(pvec, dpvecs,
                                                           *args), 3)
            bound = kernel_bound(chain, geom, k, True)
            print(f"time, osc_chain_multitangent {dname} (K={k}),"
                  f" {tile_line(tiles)}: kernel {device_ms:.5f} ms"
                  f" device-only (CUDA graph), {host_ms:.5f} ms with enqueue;"
                  f" {k} tangent launches {sep_ms:.5f} ms device-only,"
                  f" {sep_host_ms:.5f} ms with enqueue (the better of two"
                  f" turns each); plain PyTorch {plain_ms:.4f} ms; bound"
                  f" {bound['bound_ms']:.5f} ms by {bound['bound_by']}"
                  f" ({bound['ops']} operations, {bound['bytes']} bytes):"
                  f" {100 * bound['bound_ms'] / device_ms:.1f}% of it")
            if k == 3:
                summary[dname] = {
                    "max_abs_err": max(errs["plain_p"], errs["plain_t_abs"]),
                    "max_rel_err": errs["plain_t"], "ms": device_ms,
                    "host_ms": host_ms, "plain_ms": plain_ms,
                    "tangents_ms": sep_ms, **bound}
        for k in range(1, chain.MAX_TANGENTS + 1):
            a = resources(chain, "osc_chain_multitangent", dtype, k)
            if k == 3:
                summary[dname].update(a)
    return summary


def lane_kernels(chain):
    """The three kernels with a lane axis at the main path's shapes (the
    flagship geometry, KERNEL_LANES lanes: the ensemble's trials), float64
    and float32. The lanes are distinct: the nominal and seeded random
    theta, neutrinos in the even lanes and antineutrinos in the odd ones.
    One launch over all lanes is held against the plain version's lane axis
    in float64 on the same inputs, within the single launches' bounds
    (primal absolute; tangents relative to each lane's and direction's
    largest): in float32 that is the kernel's own error, where the float32
    plain version has one of its own (printed beside it; its tangents reach
    1e-3 of their largest at some of these lanes). Lane b is held against a
    single launch at pack b (0.0 in float64: the same code in the same
    order).
    Then each kernel's device-only time (a CUDA graph) over the first
    KERNEL_TIME_LANES of those lanes beside as many single launches, with
    each lane count's bound. Returns per kernel and dtype the errors and
    the times by lane count."""
    import torch

    summary = {name: {} for name in KERNELS}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        geom, params = flagship_geometry(dtype)
        args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
        args64 = tuple(a.double() for a in args[:3]) + args[3:]
        tiles = geom["tiles"]
        theta = torch.tensor(flagship_thetas(params, KERNEL_LANES),
                             dtype=torch.float64)
        nu = (torch.arange(KERNEL_LANES) % 2 == 0)[:, None]
        pvec = torch.where(nu, chain.theta_to_pvec(theta, 1),
                           chain.theta_to_pvec(theta, -1))
        pvec = pvec.to("cuda", dtype).contiguous()
        dirs = torch.where(nu[..., None], chain.pack_jacobian(theta, 1),
                           chain.pack_jacobian(theta, -1))
        dirs = dirs[..., list(FREE_THETA)].transpose(1, 2)
        dirs = dirs.to("cuda", dtype).contiguous()  # (B, K, 57)
        # name: (tangents K, directions, the kernel, its plain version,
        # which outputs are tangents)
        cases = {
            "osc_chain": (
                0, None,
                lambda p, d: (chain.chain_probs(p, *args, tiles),),
                lambda p, d, a: (chain.chain_probs_reference(p, *a),),
                (False,)),
            "osc_chain_tangent": (
                1, dirs[:, 1].contiguous(),
                lambda p, d: (chain.chain_tangent(p, d, *args, tiles),),
                lambda p, d, a: (chain.chain_tangent_reference(p, d, *a),),
                (True,)),
            "osc_chain_multitangent": (
                len(FREE_THETA), dirs,
                lambda p, d: chain.chain_multitangent(p, d, *args, tiles),
                lambda p, d, a: chain.chain_multitangent_reference(p, d, *a),
                (False, True)),
        }

        def errors(outputs, ref, tangent):
            """Max abs difference, max tangent difference relative to each
            lane's and direction's largest, max primal difference."""
            err_abs = err_rel = primal_err = 0.0
            for g, r, is_tangent in zip(outputs, ref, tangent):
                diff = (g.double() - r).abs()
                err_abs = max(err_abs, float(diff.max()))
                if is_tangent:
                    scale = r.abs().amax(dim=(-3, -2, -1), keepdim=True)
                    err_rel = max(err_rel, float((diff / scale).max()))
                else:
                    primal_err = max(primal_err, float(diff.max()))
            return err_abs, err_rel, primal_err

        for name, (k, d, run, plain, tangent) in cases.items():
            t0 = time.perf_counter()
            got = run(pvec, d)
            ref = plain(pvec.double(), None if d is None else d.double(),
                        args64)
            torch.cuda.synchronize()
            for g in got:
                check(bool(torch.isfinite(g).all()),
                      f"{dname}: {name} with lanes not finite")
            err_abs, err_rel, primal_err = errors(got, ref, tangent)
            plain_own = ""
            if dtype != torch.float64:
                own = errors(plain(pvec, d, args), ref, tangent)
                plain_own = (f"; the {dname} plain version vs float64:"
                             f" primal {own[2]:.3e} abs, tangents"
                             f" {own[1]:.3e} rel")
            del ref
            vs_single = 0.0
            for b in range(KERNEL_LANES):
                single = run(pvec[b], None if d is None else d[b])
                for g, s in zip(got, single):
                    vs_single = max(vs_single, float((g[b] - s).abs().max()))
            bound_rel = TANGENT_RTOL[dname]
            bound_abs = (MULTI_PRIMAL_ATOL[dname] if k else KERNEL_ATOL[dname])
            print(f"lanes, {name} {dname}: {KERNEL_LANES} distinct lanes in"
                  f" one launch vs plain (float64): primal {primal_err:.3e}"
                  f" abs (bound {bound_abs:g}), tangents {err_rel:.3e} rel"
                  f" (bound {bound_rel:g}){plain_own}; vs {KERNEL_LANES}"
                  f" single launches {vs_single:.3e}"
                  f" ({'must be 0.0' if dtype == torch.float64 else 'float32'});"
                  f" {time.perf_counter() - t0:.1f} s")
            check(primal_err <= bound_abs and err_rel <= bound_rel,
                  f"{dname}: {name} lanes disagree with the plain version")
            if dtype == torch.float64:
                check(vs_single == 0.0,
                      f"{name}: a lane differs from its single launch by"
                      f" {vs_single}")
            times = {}
            for lanes in KERNEL_TIME_LANES:
                times[lanes] = time_lanes(
                    f"{name} {dname}, {lanes} lanes", chain, geom, run,
                    pvec[:lanes].contiguous(),
                    None if d is None else d[:lanes].contiguous(), k,
                    not tangent[0])
            summary[name][dname] = {"max_abs_err": err_abs,
                                    "max_rel_err": err_rel,
                                    "vs_single": vs_single, "lanes": times}
    return summary


def time_lanes(label, chain, geom, run, pvec, d, k, with_primal):
    """`run(pvec, d)`'s device-only time (a CUDA graph) over the lanes of
    `pvec` (and of the directions `d`, or None) in one launch, beside as
    many single launches, with the launch's bound (kernel_bound); printed
    and returned."""
    lanes = pvec.shape[0]
    batched_ms = graph_time(lambda: run(pvec, d),
                            launches=max(3, 200 // lanes))
    singles_ms = graph_time(
        lambda: [run(pvec[b], None if d is None else d[b])
                 for b in range(lanes)],
        launches=max(2, 200 // lanes))
    bound = kernel_bound(chain, geom, k, with_primal, lanes)
    print(f"time, {label}: one launch {batched_ms:.5f} ms device-only (CUDA"
          f" graph), {lanes} single launches {singles_ms:.5f} ms; bound"
          f" {bound['bound_ms']:.5f} ms by {bound['bound_by']}"
          f" ({bound['ops']} operations, {bound['bytes']} bytes):"
          f" {100 * bound['bound_ms'] / batched_ms:.1f}% of it")
    return {"ms": batched_ms, "singles_ms": singles_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}


def tile_line(tiles):
    t = tiles["tile"]
    return (f"{t.shape[0]} tiles of <= {int(t[:, 3].max())} steps"
            f" ({tiles['rho'].shape[0]} steps)")


def resources(chain, name, dtype, k=1):
    """Print and return a kernel's registers, local memory, shared memory,
    block size and resident blocks per SM (CUDA's occupancy calculator); the
    multitangent's for K = k, with the directions a thread holds in its
    phases 1 and 2."""
    dname = str(dtype).split(".")[-1]
    a = chain.kernel_attributes(name, dtype, k)
    tag = ""
    if name == "osc_chain_multitangent":
        tag = f" K={k} (c1={a['c1']}, c2={a['c2']})"
    print(f"resources, {name} {dname}{tag}: {a['registers']} registers,"
          f" {a['local_bytes']} B local memory (stack frame and spills) per"
          f" thread,"
          f" {a['shared_bytes']} B shared per block, {a['threads']}"
          f" threads per block, {a['blocks_per_sm']} resident blocks per SM"
          f" ({a['blocks_per_sm'] * a['threads'] // 32} of 64 warps)")
    return a


def graph_time(fn, launches=200, replays=5):
    """Device-only time of one fn() call: `launches` calls captured in one
    CUDA graph, replayed `replays` times between CUDA events, so the host's
    enqueue is outside the timed region."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (launches * replays)
    del graph
    return ms


def cuda_time(fn, reps):
    """Time of one fn() call over `reps` back-to-back calls between CUDA
    events: the device's time, or the host's enqueue where that is
    slower."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timed_once(fn):
    """(fn(), the time of that one call between CUDA events): for plain
    versions slow enough that one call is a measurement and its result is
    needed anyway."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def compare(ref, got, label, dname, n_events_mask):
    import numpy as np

    worst_w = worst_e = 0.0
    for name, ref_w in ref[0].items():
        mask = (np.abs(ref_w) >= MIN_EVENTS_FP32) if n_events_mask else None
        worst_w = max(worst_w, max_rel(ref_w, got[0][name], mask))
        worst_e = max(worst_e, max_rel(ref[1][name], got[1][name], mask))
    scope = "bins >= 1 event" if n_events_mask else "all bins"
    print(f"template {label}, card {dname} vs CPU float64 ({scope}): max rel"
          f" weights {worst_w:.3e}, errors {worst_e:.3e}"
          f" (bound {TEMPLATE_RTOL[dname]:g})")
    check(worst_w <= TEMPLATE_RTOL[dname] and worst_e <= TEMPLATE_RTOL[dname],
          f"{label}: card {dname} template off the CPU reference")


def check_gradient_fp64(ref):
    """Phase checks of the float64 value_and_grad (run in the child)."""
    free_names = [str(n) for n in ref["vg|free_names"]]
    value, grad = float(ref["vg|value"]), ref["vg|grad"]
    cpu_value, cpu_grad = float(ref["vg|cpu_value"]), ref["vg|cpu_grad"]
    print(f"value_and_grad, float64, full width, {len(free_names)} free"
          f" params: card {value!r} vs CPU {cpu_value!r}")
    for name, a, b, f in zip(free_names, grad, cpu_grad, ref["vg|fd"]):
        print(f"  d/d {name:22s} card {a: .10e}  CPU {b: .10e}"
              f"  central FD {f: .10e}")
    value_err = abs(value - cpu_value) / abs(cpu_value)
    grad_err = grad_mismatch(grad, cpu_grad, VG_FP64["grad_rtol"],
                             VG_FP64["grad_atol"])
    fd_err = grad_mismatch(ref["vg|fd"], grad, FD_TOL["rtol"], FD_TOL["atol"])
    multi_err = rel_max(ref["vg|grad_multi"], grad)
    print(f"  card vs CPU: value rel {value_err:.3e} (bound"
          f" {VG_FP64['value']:g}); gradient {rel_max(grad, cpu_grad):.3e} of"
          f" max|g|, worst entry at {grad_err:.3e} of its bound (rtol"
          f" {VG_FP64['grad_rtol']:g}, atol {VG_FP64['grad_atol']:g} max|g|);"
          f" CPU value_and_grad {float(ref['vg|cpu_seconds']):.1f} s")
    print(f"  central FD (h={FD_STEP:g}) vs card: {rel_max(ref['vg|fd'], grad):.3e}"
          f" of max|g|, worst entry at {fd_err:.3e} of its bound")
    print(f"  separate tangents vs multitangent: {multi_err:.3e} of max|g|"
          f" (bound {TANGENTS_VS_MULTI['float64']:g}); values"
          f" {value!r} / {float(ref['vg|value_multi'])!r}")
    launches = tuple(int(x) for x in ref["vg|launches"])
    launches_m = tuple(int(x) for x in ref["vg|launches_multi"])
    print(f"  launches (primal, tangent, multitangent) per value_and_grad:"
          f" {launches} separate, {launches_m} multitangent")
    check(value_err <= VG_FP64["value"], "float64 card value off the CPU's")
    check(grad_err <= 1.0, "float64 card gradient off the CPU's")
    check(fd_err <= 1.0, "float64 gradient off the finite differences")
    check(multi_err <= TANGENTS_VS_MULTI["float64"],
          "float64 multitangent gradient off the separate tangents'")
    check(launches == expected_vg_launches(False),
          f"float64 value_and_grad launches {launches}")
    check(launches_m == expected_vg_launches(True),
          f"float64 multitangent value_and_grad launches {launches_m}")


def median_wall(fn, reps):
    import numpy as np
    import torch

    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls)), float(min(walls))


def count_host_syncs(fn, sources=None):
    """fn() with torch's CUDA sync debug mode warning at every operation
    that waits for the card (a value read back, a copy to the host); returns
    the number of such waits and fn's result. With `sources` (a dict), also
    counts the waits there by the source line Python gives each warning
    ("file:line"; a wait inside the backward pass is reported at the line
    that started it)."""
    import warnings

    import torch

    # the mode is switched outside the recorded region: the first switch in
    # a process may itself warn, and that is no wait of fn's
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            result = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    if sources is not None:
        for w in syncs:
            where = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            sources[where] = sources.get(where, 0) + 1
    return len(syncs), result


def print_host_sync_sources(label, fn):
    """One fn() under the sync debug mode: its waits for the card, grouped
    by source line, most frequent first; returns their number."""
    import linecache

    sources = {}
    syncs, _ = count_host_syncs(fn, sources)
    print(f"host syncs of one {label}: {syncs}, by source line:")
    for where, count in sorted(sources.items(), key=lambda x: -x[1]):
        path, line = where.rsplit(":", 1)
        text = linecache.getline(os.path.join(ROOT, path), int(line)).strip()
        print(f"  {count:4d}x  {where}  {text[:80]}")
    return syncs


# profiler entries that copy to the host or wait for the card
_SYNC_KEYS = ("Memcpy DtoH", "Memcpy HtoD", "cudaStreamSynchronize",
              "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpyAsync",
              "aten::_local_scalar_dense", "aten::item", "aten::_to_copy",
              "ToCopyBackward")


def print_host_copy_ops(label, fn):
    """One fn() under torch.profiler: the calls of the operators, autograd
    nodes and runtime functions that copy to the host or wait for the card
    (the sync debug mode reports every wait inside the backward pass at the
    one line that started it; this names the nodes). Returns the numbers of
    copies between host and card that the device saw: (host to card, card to
    host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    print(f"copies between host and card, and waits, in one {label}"
          " (torch.profiler):")
    h2d = d2h = 0
    for e in sorted(prof.key_averages(), key=lambda e: -e.count):
        if any(k in e.key for k in _SYNC_KEYS):
            print(f"  {e.count:4d}x  {e.key[:90]}")
        if "Memcpy HtoD" in e.key:
            h2d += e.count
        if "Memcpy DtoH" in e.key:
            d2h += e.count
    return h2d, d2h


def profile_device_busy(fn):
    """torch.profiler over one call: its wall, the device time of the
    kernels and copies it ran and their number, and the ops with the most
    device and host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def device_us(event):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(event, attr):
                return float(getattr(event, attr))
        return 0.0

    def on_device(event):
        return getattr(event, "device_type", None) is not None and str(
            event.device_type).endswith("CUDA")

    events = prof.key_averages()
    total_us = sum(device_us(e) for e in events)
    launches = sum(e.count for e in events if on_device(e))
    top = sorted(events, key=device_us, reverse=True)[:8]
    top_host = sorted(events, key=lambda e: e.self_cpu_time_total,
                      reverse=True)[:8]
    return (wall, total_us / 1e3,
            [(e.key, device_us(e) / 1e3, e.count)
             for e in top if device_us(e) > 0],
            [(e.key, e.self_cpu_time_total / 1e3, e.count)
             for e in top_host], launches)


def replay_time(fn, reps=20):
    """Device time of one fn() over `reps` back-to-back calls between CUDA
    events, for an fn that only enqueues (a graph replay): the card never
    waits for the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def read_back(result):
    """A (value, gradient) pair on the host in one copy: the one wait that a
    value_and_grad costs its caller."""
    import torch

    value, grad = result
    return torch.cat([value.reshape(1), grad]).cpu().numpy()


def gradient_and_fit_fp32(pipeline, chain, ref, smi):
    """The slice's main path in float32 on the card: the per-container eager
    value_and_grad (separate tangents, then the multitangent), then
    ``compile()``'s default route (the categories stacked, value_and_grad
    captured in a CUDA graph) with its value_and_grad and the Asimov fit on
    the captured objective; checks against the float64 card run; then the
    route table, waits and times. Returns the launch counts of the main
    path and the timings."""
    import numpy as np
    import torch

    from pisa_tpu_torch.analysis.device_fit import minimize_on_device
    from pisa_tpu_torch.core import template as template_module

    pipeline.params.reset_all()
    free_names = [str(n) for n in ref["vg|free_names"]]
    data = {k.split("|", 1)[1]: v for k, v in ref.items()
            if k.startswith("data|")}
    v = ref["vg|v"]
    torch.cuda.reset_peak_memory_stats()

    # -- the main path: counts from 0 to here ...
    reset_launch_counts(chain)
    t0 = time.perf_counter()
    eager_ct = pipeline.compile(stack=False)
    eager_compile_s = time.perf_counter() - t0
    check(eager_ct.free_names == free_names, "float32 free params differ")
    _, eager_vg = eager_ct.build_objective(data, "mod_chi2", capture=False)
    value, grad, launches = value_and_grad_counted(pipeline, chain, eager_vg,
                                                   v, False)
    value_m, grad_m, launches_m = value_and_grad_counted(
        pipeline, chain, eager_vg, v, True)

    t0 = time.perf_counter()
    ct = pipeline.compile()
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    check(ct.stacked, "compile()'s default route did not stack the flagship")
    before = launch_counts(chain)
    t0 = time.perf_counter()
    _, vg = ct.build_objective(data, "mod_chi2")
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    launches_c = tuple(a - b for a, b in zip(launch_counts(chain), before))
    captured = read_back(vg(v))
    value_c, grad_c = float(captured[0]), captured[1:]
    v0 = ct.current_rescaled_values()
    asimov = ct.get_outputs(v0)
    fit_value_fn, _ = ct.build_objective(asimov, "mod_chi2")
    i23 = ct.free_names.index("theta23")
    x0 = v0.copy()
    x0[i23] = min(0.95, x0[i23] + 0.10)
    los, his = ct._current_bounds()
    t0 = time.perf_counter()
    fit = minimize_on_device(fit_value_fn.raw, x0, los, his)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    main_path = launch_counts(chain)
    # ... and read here.

    value64, grad64 = float(ref["vg|value"]), ref["vg|grad"]
    value_err = abs(value - value64) / abs(value64)
    grad_err = grad_mismatch(grad, grad64, VG_FP32["grad_rtol"],
                             VG_FP32["grad_atol"])
    multi_err = rel_max(grad_m, grad)
    print(f"value_and_grad, float32 card (per container, eager) vs float64"
          f" card: value {value!r} vs"
          f" {value64!r} (rel {value_err:.3e}, bound {VG_FP32['value']:g});"
          f" gradient {rel_max(grad, grad64):.3e} of max|g|, worst entry at"
          f" {grad_err:.3e} of its bound (rtol {VG_FP32['grad_rtol']:g}, atol"
          f" {VG_FP32['grad_atol']:g} max|g|)")
    for name, a, b in zip(free_names, grad, grad64):
        print(f"  d/d {name:22s} float32 {a: .6e}  float64 {b: .6e}"
              f"  rel {abs(a - b) / max(abs(b), 1e-300):.2e}")
    print(f"  separate tangents vs multitangent (float32): {multi_err:.3e} of"
          f" max|g| (bound {TANGENTS_VS_MULTI['float32']:g})")
    print(f"  launches (primal, tangent, multitangent) per value_and_grad:"
          f" {launches} separate, {launches_m} multitangent")
    check(value_err <= VG_FP32["value"], "float32 value off float64")
    check(grad_err <= 1.0, "float32 gradient off float64")
    check(multi_err <= TANGENTS_VS_MULTI["float32"],
          "float32 multitangent gradient off the separate tangents'")
    check(launches == expected_vg_launches(False),
          f"float32 value_and_grad launches {launches}")
    check(launches_m == expected_vg_launches(True),
          f"float32 multitangent value_and_grad launches {launches_m}")

    route = (f"stacked, {'deferral' if ct.rate_deferred else 'gather'},"
             " captured")
    value_err = abs(value_c - value64) / abs(value64)
    grad_err = grad_mismatch(grad_c, grad64, VG_FP32["grad_rtol"],
                             VG_FP32["grad_atol"])
    print(f"value_and_grad, float32 card, compile()'s default route ({route};"
          f" compile {compile_s:.3f} s, capture {capture_s:.3f} s, launches"
          f" at capture {launches_c}) vs float64 card: value {value_c!r} (rel"
          f" {value_err:.3e}); gradient {rel_max(grad_c, grad64):.3e} of"
          f" max|g|, worst entry at {grad_err:.3e} of its bound; vs float32"
          f" per container: value rel {abs(value_c - value_m) / abs(value_m):.3e}"
          f" (bound {STACKED_FP32['value']:g}), gradient"
          f" {rel_max(grad_c, grad_m):.3e} of max|g| (bound"
          f" {STACKED_FP32['grad']:g})")
    check(value_err <= VG_FP32["value"] and grad_err <= 1.0,
          "float32 captured value_and_grad off float64")
    check(abs(value_c - value_m) / abs(value_m) <= STACKED_FP32["value"]
          and rel_max(grad_c, grad_m) <= STACKED_FP32["grad"],
          "float32 stacked value_and_grad off the per-container one")
    check(launches_c == captured_launches(template_module),
          f"float32 launches at capture {launches_c}")

    moved = float(fit["x"][i23] - v0[i23])
    print(f"Asimov fit, float32 on the card, on the captured objective"
          f" ({route}), from theta23 +0.10 rescaled:"
          f" nit {fit['nit']}, nfev {fit['nfev']}, fun {fit['fun']!r},"
          f" theta23 off by {moved:.3e}"
          f" rescaled (bound {FIT_TOL:g}), largest param offset"
          f" {float(np.abs(fit['x'] - v0).max()):.3e}; wall {fit_s:.3f} s"
          f" [{smi}]")
    check(np.isfinite(fit["fun"]) and abs(moved) <= FIT_TOL,
          "the Asimov fit did not recover theta23")
    print(f"main path (2 eager value_and_grad per container, compile,"
          f" capture, value_and_grad, fit) launches: primal"
          f" {main_path[0]}, tangent {main_path[1]}, multitangent"
          f" {main_path[2]}; eager compile {eager_compile_s:.3f} s")
    check(all(n > 0 for n in main_path), "a kernel of the path never ran")

    # -- the fit's waits, and the fit as it ran before (per container, eager)
    times = {"compile_s": compile_s, "capture_s": capture_s, "fit_s": fit_s,
             "fit_nit": fit["nit"]}
    syncs, again = count_host_syncs(
        lambda: minimize_on_device(fit_value_fn.raw, x0, los, his))
    print(f"host syncs of the fit on the captured objective (torch.cuda sync"
          f" debug mode, a second run):"
          f" {syncs} over {again['nit']} iterations and {again['nfev']}"
          f" evaluations ({syncs / max(again['nfev'], 1):.2f} per evaluation:"
          f" {again['reads']} flag reads of the L-BFGS loop, the rest the"
          f" reads of its result)")
    eager_fit_fn, _ = eager_ct.build_objective(asimov, "mod_chi2",
                                               capture=False)
    t0 = time.perf_counter()
    eager_fit = minimize_on_device(eager_fit_fn.raw, x0, los, his,
                                   max_steps=EAGER_FIT_STEPS)
    torch.cuda.synchronize()
    print(f"Asimov fit, float32, per container and eager (one run, at most"
          f" {EAGER_FIT_STEPS} iterations): nit"
          f" {eager_fit['nit']}, nfev {eager_fit['nfev']}, theta23 off by"
          f" {float(eager_fit['x'][i23] - v0[i23]):.3e}; wall"
          f" {time.perf_counter() - t0:.3f} s [{smi}]")
    check(abs(float(eager_fit["x"][i23] - v0[i23])) <= FIT_TOL,
          "the eager Asimov fit did not recover theta23")
    print(f"torch.cuda.max_memory_allocated (float32: both templates, the"
          f" captured objectives, the fits):"
          f" {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB [{smi}]")
    del vg, fit_value_fn
    times.update(route_table(pipeline, chain, data, v, value_m, grad_m, smi))
    return main_path, times


def route_table(pipeline, chain, data, v, value_ref, grad_ref, smi):
    """value and value_and_grad by every route (ROUTES), float32 at full
    size: each route's result against the per-container one, its waits for
    the card (which must be the read of the result and nothing else), its
    copies from the host, its launches, device time, host-clock time and
    peak memory; the per-container route with fewer repetitions. Then the
    separate-tangents route beside the multitangent, per container and
    eager, as before."""
    import torch

    from pisa_tpu_torch.core import template as template_module

    rows = {}
    v_card = torch.as_tensor(v, device="cuda")
    for label, options, capture in ROUTES:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ct = pipeline.compile(**options)
        stacked = options.get("stack", True)
        check(ct.stacked is stacked
              and ct.rate_deferred is options.get("rate_defer", False),
              f"{label}: stacked={ct.stacked},"
              f" rate_deferred={ct.rate_deferred}")
        took = deferred_calls(ct.get_outputs)
        check(took == first_call_runs(ct, template_module) * ct.rate_deferred,
              f"{label}: {took} factorized histograms in the first template")
        value_fn, vg = ct.build_objective(data, "mod_chi2", capture=capture)
        # the eager routes take the vector where it lies (on the card); the
        # captured one brings an array over through its pinned buffer
        vin = v if capture else v_card
        got = read_back(vg(vin))
        v_err = abs(float(got[0]) - value_ref) / abs(value_ref)
        g_err = rel_max(got[1:], grad_ref)
        check(v_err <= STACKED_FP32["value"] and g_err <= STACKED_FP32["grad"],
              f"{label}: off the per-container value_and_grad by {v_err},"
              f" {g_err}")
        waits = print_host_sync_sources(
            f"float32 value_and_grad and its read, {label}",
            lambda: read_back(vg(vin)))
        value_waits = print_host_sync_sources(
            f"float32 value and its read, {label}",
            lambda: value_fn(vin).cpu())
        h2d, d2h = print_host_copy_ops(f"float32 value_and_grad, {label}",
                                       lambda: vg(vin))
        check(waits == 1 and value_waits == 1,
              f"{label}: {waits} waits for the card in a value_and_grad and"
              f" {value_waits} in a value; only the read of the result may"
              " wait")
        check(d2h == 0 and h2d == (1 if capture else 0),
              f"{label}: {h2d} copies from the host and {d2h} to it inside"
              " one value_and_grad")
        reps = 5 if not stacked else 10
        vg(vin)
        wall_vg = median_wall(lambda: vg(vin), reps)
        wall_value = median_wall(lambda: value_fn(vin), reps)
        profiled = [profile_device_busy(lambda: vg(vin)) for _ in range(2)]
        wall, busy_ms, top, top_host, launches = profiled[-1]
        row = {"vg_ms": wall_vg[0] * 1e3, "value_ms": wall_value[0] * 1e3,
               "device_ms": min(p[1] for p in profiled),
               "launches": launches, "waits": waits,
               "busy": busy_ms / (wall_vg[0] * 1e3),
               "peak_mib": (torch.cuda.max_memory_allocated() - base) / 2**20}
        line = (f"route {label}: value_and_grad wall median"
                f" {row['vg_ms']:.3f} ms (min {wall_vg[1] * 1e3:.3f}), value"
                f" {row['value_ms']:.3f} ms (min {wall_value[1] * 1e3:.3f}),"
                f" {reps} calls each; device time (torch.profiler, the lower"
                f" of two calls) {row['device_ms']:.3f} ms, busy"
                f" {100 * row['busy']:.1f}% of the median wall; {launches}"
                f" kernels and copies on the device, {waits} wait (the"
                f" read), {h2d} copy from the host")
        if capture:
            row["replay_ms"] = replay_time(lambda: vg(vin))
            row["value_replay_ms"] = replay_time(lambda: value_fn(vin))
            line += (f"; 20 replays back to back (CUDA events):"
                     f" {row['replay_ms']:.3f} ms per value_and_grad,"
                     f" {row['value_replay_ms']:.3f} ms per value")
        print(f"{line}; peak memory above what was resident"
              f" {row['peak_mib']:.1f} MiB [{smi}]")
        print("  most device time:")
        for key, ms, count in top:
            print(f"  {ms:9.3f} ms  {count:5d}x  {key[:90]}")
        print("  most host time (self, under the profiler):")
        for key, ms, count in top_host[:5]:
            print(f"  {ms:9.3f} ms  {count:5d}x  {key[:90]}")
        rows[label] = row
        del vg, value_fn, ct

    on, off = (rows[f"stacked captured, {r}"]["replay_ms"]
               for r in ("deferral", "gather"))
    default = "deferral" if template_module.RATE_DEFER_DEFAULT else "gather"
    print(f"captured value_and_grad, device only: deferral {on:.3f} ms,"
          f" gather {off:.3f} ms; compile()'s default: {default} [{smi}]")

    # separate tangents beside the multitangent: per container, eager
    ct = pipeline.compile(stack=False)
    _, vg = ct.build_objective(data, "mod_chi2", capture=False)
    stage = pipeline["osc.prob3"]
    default = stage.multitangent
    routes = (("separate tangents", False), ("multitangent", True))
    device_ms = {label: [] for label, _ in routes}
    # one profiled call per turn: separate, multitangent, multitangent,
    # separate
    for label, multi in routes + routes[::-1]:
        stage.multitangent = multi
        vg(v_card)
        device_ms[label].append(profile_device_busy(lambda: vg(v_card))[1])
    stage.multitangent = default
    for label, ms in device_ms.items():
        print(f"float32 per-container eager value_and_grad, {label}: device"
              f" time (torch.profiler, one call a turn)"
              f" {' / '.join(f'{x:.4f}' for x in ms)} ms [{smi}]")
    print(f"prob3's default route: {routes[1 if default else 0][0]}")
    return {"routes": rows}


def template_fp32(pipeline, chain, smi):
    """The captured template call at full size, float32: compile()'s
    default template, captured at its first call; each of N_TEMPLATES
    randomized vectors (bench.py:251-252) timed on the host clock ending in
    synchronize(), the first excluded; scan_totals over the same vectors,
    which must wait once (its read). Returns the path's launches and the
    numbers."""
    import numpy as np
    import torch

    reset_launch_counts(chain)
    t0 = time.perf_counter()
    ct = pipeline.compile()
    vecs = np.random.RandomState(0).uniform(0.05, 0.95,
                                            (N_TEMPLATES, len(ct.free_names)))
    ct(vecs[0])  # the capture
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    walls = []
    for v in vecs:
        t0 = time.perf_counter()
        ct(v)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    template_ms = float(np.median(walls[1:])) * 1e3
    t0 = time.perf_counter()
    scanned = ct.scan_totals(vecs).cpu().numpy()
    scan_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts(chain)

    call_waits, maps = count_host_syncs(lambda: ct.get_outputs(vecs[1]))
    scan_waits, again = count_host_syncs(
        lambda: ct.scan_totals(vecs).cpu().numpy())
    check_template(({m.name: m.hist for m in maps},
                    {m.name: m.error_hist for m in maps}),
                   "float32 captured template call")
    totals = [float(sum(m.hist.sum() for m in ct.get_outputs(v)))
              for v in vecs[:5]]
    err = max_rel(totals, scanned[:5])
    replay_ms = replay_time(lambda: ct(vecs[1]))
    print(f"template phase (compile()'s default, {ct.stacked and 'stacked'},"
          f" captured at the first call; set-up and capture {setup_s:.2f} s):"
          f" ct(vec) median {template_ms:.4f} ms over {N_TEMPLATES - 1}"
          f" randomized vectors (host clock ending in synchronize()), i.e."
          f" {1e3 / template_ms:.1f} templates/s; 20 calls back to back"
          f" (CUDA events) {replay_ms:.4f} ms each; scan_totals over"
          f" {N_TEMPLATES} vectors {scan_ms:.2f} ms"
          f" ({N_TEMPLATES * 1e3 / scan_ms:.1f} templates/s) with"
          f" {scan_waits} wait; get_outputs waits {call_waits} time(s)"
          f" [{smi}]")
    print(f"  scan_totals vs get_outputs totals (float32, 5 vectors): max rel"
          f" {err:.3e}; launches at the capture {launches}")
    check(scan_waits == 1, f"scan_totals waited {scan_waits} times")
    check(call_waits == 1, f"a captured get_outputs waited {call_waits}"
          " times")
    check(np.all(np.isfinite(scanned)) and np.array_equal(scanned, again),
          "scan_totals not finite or not repeatable")
    check(err <= 1e-5, "scan_totals off the calls' totals")
    del ct
    return launches, {"template_ms": template_ms, "scan_ms": scan_ms,
                      "replay_ms": replay_ms}


def analysis_fp32(chain, ureg, smi):
    """The slice's main path at full size, float32: DistributionMaker over
    the flagship on the card, Asimov data at nominal, theta23 moved by +0.10
    rescaled, then Analysis().fit_recursively with method 'device', with
    method 'gradient' and with the octant strategy around 'device'. Each
    fit runs twice: the first builds and captures (set-up), the second is
    timed and counts its waits for the card (torch's sync debug mode, which
    adds ~0.1 ms to each wait). Returns the path's launches."""
    import torch

    from pisa_tpu_torch.analysis.analysis import Analysis, BasicAnalysis
    from pisa_tpu_torch.core.distribution_maker import DistributionMaker

    reset_launch_counts(chain)
    t0 = time.perf_counter()
    dm = DistributionMaker([CFG], device="cuda")
    data = dm.get_outputs(return_sum=True)
    print(f"analysis phase: DistributionMaker set-up and Asimov data"
          f" {time.perf_counter() - t0:.2f} s")
    truth = dm.params["theta23"]._rescaled_value
    fits = (
        ("device", "device", {}, None),
        ("gradient", "gradient", {}, None),
        ("octants around device", "octants",
         {"angle": "theta23", "inflection_point": 45 * ureg.degree},
         {"method": "device", "method_kwargs": {}}),
    )
    for label, method, method_kwargs, local in fits:
        def fit():
            dm.reset_free()
            dm.params["theta23"]._rescaled_value = min(0.95, truth + 0.10)
            return Analysis().fit_recursively(data, dm, "mod_chi2", None,
                                              method, method_kwargs, local)

        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        waits, result = count_host_syncs(fit)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        meta = result.minimizer_metadata
        moved = result.params["theta23"]._rescaled_value - truth
        print(f"Analysis fit, {label}, float32: wall {wall:.3f} s (first run"
              f" with set-up and capture {first_s:.2f} s), nit {meta['nit']},"
              f" nfev {meta['nfev']}, {waits} waits for the card"
              f" ({waits / meta['nfev']:.2f} per evaluation"
              f"{', both octants over the winner' if local else ''}),"
              f" theta23 off by {moved:.3e} rescaled (bound {FIT_TOL:g}),"
              f" metric {result.metric_val!r} [{smi}]")
        check(abs(moved) <= FIT_TOL, f"the {label} fit did not recover theta23")
        if method == "device":
            check(waits / meta["nfev"] <= DEVICE_FIT_WAITS,
                  f"the device fit waited {waits / meta['nfev']:.2f} times"
                  " per evaluation")
    launches = launch_counts(chain)
    print(f"analysis path launches: primal {launches[0]}, tangent"
          f" {launches[1]}, multitangent {launches[2]}; peak memory"
          f" {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB [{smi}]")
    check(launches[0] > 0 and launches[2] > 0,
          "a kernel of the analysis path never ran")
    # the compiled objectives live in a class-level cache
    BasicAnalysis._compiled_cache.clear()
    del dm
    return launches


def ensemble_fp32(chain, smi):
    """The slice's main path at full width, float32: the flagship's
    DistributionMaker on the card, its CompiledDistribution, and
    fit_pseudo_ensemble(cd, "llh", n_trials=ENSEMBLE_TRIALS, seed=0,
    max_steps=ENSEMBLE_MAX_STEPS), which captures its batched objective
    (counts set to 0 just before it, read just after). Then the batched
    objective (value_fn.raw_with_data) at VG_LANES lanes: its launches per
    eager value_and_grad (which must not grow with the lanes), the captured
    value_and_grad's capture, wall (one wait) and back-to-back time, and the
    peak memory; and one solo minimize_on_device fit of trial 0's data from
    the same start. Returns the ensemble's launches."""
    import numpy as np
    import torch

    from pisa_tpu_torch import TORCH_FTYPE
    from pisa_tpu_torch.analysis.device_fit import (
        fit_pseudo_ensemble,
        minimize_on_device,
    )
    from pisa_tpu_torch.analysis.gradient import CompiledDistribution
    from pisa_tpu_torch.core.distribution_maker import DistributionMaker

    t0 = time.perf_counter()
    dm = DistributionMaker([CFG], device="cuda")
    cd = CompiledDistribution(dm)
    x_nom = cd.current_rescaled_values()
    asimov = cd.sum_hist(x_nom)
    value_fn, _ = cd.build_objective(asimov, "llh")
    torch.cuda.synchronize()
    print(f"ensemble phase: DistributionMaker, CompiledDistribution and"
          f" objective set-up {time.perf_counter() - t0:.2f} s [{smi}]")

    # -- the main path
    reset_launch_counts(chain)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ens = fit_pseudo_ensemble(cd, "llh", n_trials=ENSEMBLE_TRIALS, seed=0,
                              max_steps=ENSEMBLE_MAX_STEPS)
    wall = time.perf_counter() - t0
    launches = launch_counts(chain)
    nit = ens["nit"]
    print(f"fit_pseudo_ensemble, {ENSEMBLE_TRIALS} trials, flagship, float32:"
          f" wall {wall:.3f} s with the capture of its {ENSEMBLE_TRIALS}-lane"
          f" objective ({wall / ENSEMBLE_TRIALS * 1e3:.2f} ms a lane), nit"
          f" median {float(np.median(nit))} max {int(nit.max())} min"
          f" {int(nit.min())}, {ens['nfev']} evaluations, {ens['reads']} flag"
          f" reads; peak memory"
          f" {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; launches"
          f" (primal, tangent, multitangent) {launches} [{smi}]")
    check(launches[0] > 0 and launches[2] > 0,
          "a kernel of the ensemble path never ran")
    check(np.all(np.isfinite(ens["fun"])) and np.all(nit > 0),
          "the ensemble's fits are not all finite")
    check(np.all(np.isfinite(ens["magnitudes"])),
          "the ensemble's magnitudes are not all finite")
    check(len({d.tobytes() for d in ens["data"]}) == ENSEMBLE_TRIALS,
          "the ensemble's trials share data")
    nominal = [p.value.m_as(p.units) for p in cd._free_params]
    for i, name in enumerate(ens["free_names"]):
        col = ens["magnitudes"][:, i]
        print(f"  {name:22s} injected {nominal[i]: .6g}  mean"
              f" {float(col.mean()): .6g}  std {float(col.std()): .6g}")

    # -- the batched value_and_grad by lanes
    eager = cd._objective(asimov, "llh")
    los, his = cd._device_bounds()
    lam = torch.as_tensor(asimov, dtype=TORCH_FTYPE, device="cuda")
    generator = torch.Generator(device="cuda")
    generator.manual_seed(1)
    rng = np.random.RandomState(3)
    per_lane = {}
    for lanes in VG_LANES:
        x = np.clip(x_nom + rng.uniform(-0.05, 0.05, (lanes, x_nom.size)),
                    0.01, 0.99)
        vec = torch.as_tensor(x, device="cuda")
        data = torch.poisson(lam.expand(lanes, -1).contiguous(),
                             generator=generator)
        # one eager batched value_and_grad: its kernel launches
        reset_launch_counts(chain)
        v = vec.clone().requires_grad_(True)
        eager(v, los, his, data).sum().backward()
        torch.cuda.synchronize()
        vg_launches = launch_counts(chain)
        # the ensemble captured its lane count's program already
        captured = (lanes, True) in value_fn.raw_with_data.programs
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        value_fn.raw_with_data(vec, los, his, data)
        torch.cuda.synchronize()
        capture = ("by the ensemble" if captured else
                   f"{time.perf_counter() - t0:.2f} s")
        program = value_fn.raw_with_data.programs[(lanes, True)]
        program.load_extra(data)

        def vg():
            value, grad = program.value_and_grad(vec, los, his)
            return torch.cat([value.reshape(-1), grad.reshape(-1)]).cpu()

        waits = print_host_sync_sources(
            f"batched value_and_grad, {lanes} lanes", vg)
        vg_wall, wall_min = median_wall(vg, 10)
        back_ms = cuda_time(lambda: program.value_and_grad(vec, los, his),
                            20)
        peak = torch.cuda.max_memory_allocated() / 2**20
        per_lane[lanes] = vg_launches
        print(f"batched value_and_grad, {lanes} lanes, float32: wall"
              f" {vg_wall * 1e3:.3f} ms median of 10 (min"
              f" {wall_min * 1e3:.3f}), {back_ms:.3f} ms back to back"
              f" ({back_ms / lanes:.4f} ms a lane); capture {capture};"
              f" launches (primal, tangent, multitangent) per eager"
              f" value_and_grad {vg_launches}; {waits} wait(s); peak memory"
              f" {peak:.1f} MiB{' (replays only)' if captured else ''}"
              f" [{smi}]")
        check(waits == 1, f"the batched value_and_grad at {lanes} lanes"
              f" waited {waits} times")
    check(set(per_lane.values()) == {expected_vg_launches(True)},
          f"batched value_and_grad launches by lanes: {per_lane}")

    # -- one solo fit beside the ensemble
    value_0, _ = cd.build_objective(ens["data"][0], "llh")
    value_0.raw(torch.as_tensor(x_nom, device="cuda"), los, his)  # capture
    t0 = time.perf_counter()
    solo = minimize_on_device(value_0.raw, x_nom, *cd._current_bounds(),
                              max_steps=ENSEMBLE_MAX_STEPS, device="cuda")
    solo_wall = time.perf_counter() - t0
    print(f"solo minimize_on_device, trial 0's data, same start, float32:"
          f" wall {solo_wall:.3f} s, nit {solo['nit']} (lane 0: {int(nit[0])}),"
          f" {solo['nfev']} evaluations, {solo['reads']} flag reads; the"
          f" ensemble took {wall / solo_wall:.2f} solo fits' wall for"
          f" {ENSEMBLE_TRIALS} fits [{smi}]")
    del dm, cd
    return launches


def release_fp32(chain, ref, smi):
    """The release's fit at full width, float32, this slice's main path:
    the released counts and DistributionMaker([daemon neutrinos, muons]) on
    the card; the captured value_and_grad of mod_chi2 against the float64
    CPU run of the child (VG_FP32), its wall, back-to-back time, waits,
    kernel count, device busy share and peak memory, and the launches of
    one eager value_and_grad. Then, with the counts set to 0 just before
    and read just after: Analysis().fit_recursively(data, hm, "mod_chi2",
    None, "device", {}, None) from the nominal values (run twice: the
    first builds and captures, the second is timed and counts its waits)
    and fit_pseudo_ensemble(cd, "mod_chi2", n_trials=RELEASE_TRIALS,
    max_steps=RELEASE_MAX_STEPS), beside one solo fit of trial 0's data.
    Returns the launches of the fit and the ensemble."""
    import numpy as np
    import torch

    from pisa_tpu_torch.analysis.analysis import Analysis, BasicAnalysis
    from pisa_tpu_torch.analysis.device_fit import (
        fit_pseudo_ensemble,
        minimize_on_device,
    )

    t0 = time.perf_counter()
    data, hm = release_hypothesis("cuda")
    cd = BasicAnalysis()._get_compiled(hm)
    value_fn, vg = cd.build_objective(data, "mod_chi2")
    torch.cuda.synchronize()
    print(f"release phase: data, DistributionMaker([daemon neutrinos,"
          f" muons]), CompiledDistribution and captured objective set-up"
          f" {time.perf_counter() - t0:.2f} s [{smi}]")
    check(cd.free_names == [str(n) for n in ref["release|names"]],
          "release free params differ from the float64 child's")

    # -- the captured value_and_grad against the float64 CPU run
    v = ref["release|v"]
    value, grad = vg(v)
    value, grad = float(value), grad.cpu().numpy()
    rel = abs(value - float(ref["release|value"])) / abs(
        float(ref["release|value"]))
    mism = grad_mismatch(grad, ref["release|grad"], VG_FP32["grad_rtol"],
                         VG_FP32["grad_atol"])
    print(f"float32 release value_and_grad on the card vs float64 CPU: value"
          f" {value!r}, {rel:.3e} relative (bound {VG_FP32['value']:g}),"
          f" gradient at {mism:.3e} of its bound [{smi}]")
    check(np.isfinite(value) and np.all(np.isfinite(grad)),
          "the release's value_and_grad is not finite")
    check(rel <= VG_FP32["value"], "release value: float32 vs float64")
    check(mism <= 1.0, "release gradient: float32 vs float64")
    torch.cuda.reset_peak_memory_stats()
    waits, _ = count_host_syncs(lambda: read_back(vg(v)))
    vg_wall, vg_min = median_wall(lambda: read_back(vg(v)), 10)
    program = value_fn.program
    los, his = cd._device_bounds()
    vec = torch.as_tensor(v, device="cuda")
    back_ms = cuda_time(lambda: program.value_and_grad(vec, los, his), 20)
    # the second of two profiled replays (the first warms the profiler up);
    # busy: its device time over the median wall, as route_table reads it
    profiled = [profile_device_busy(
        lambda: program.value_and_grad(vec, los, his)) for _ in range(2)]
    _, device_ms, top, _, kernels = profiled[-1]
    print(f"float32 release value_and_grad (captured, one program over both"
          f" pipelines): wall {vg_wall * 1e3:.3f} ms median of 10 (min"
          f" {vg_min * 1e3:.3f}), {back_ms:.3f} ms back to back, {waits}"
          f" wait(s); one replay: {kernels} kernels, {device_ms:.3f} ms of"
          f" device time ({100 * device_ms / (vg_wall * 1e3):.1f}% busy of"
          f" the median wall); peak memory"
          f" {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB [{smi}]")
    for key, ms, count in top:
        print(f"  {ms:8.3f} ms  {count:5d}x  {key[:80]}")
    check(waits == 1, f"the release's value_and_grad waited {waits} times")
    # the launches of one eager value_and_grad
    reset_launch_counts(chain)
    eager = cd._objective(data, "mod_chi2")
    x = torch.as_tensor(v, device="cuda").requires_grad_(True)
    eager(x, los, his).backward()
    torch.cuda.synchronize()
    vg_launches = launch_counts(chain)
    print(f"release: launches (primal, tangent, multitangent) per eager"
          f" value_and_grad {vg_launches} [{smi}]")
    check(vg_launches == expected_vg_launches(True),
          f"release value_and_grad launches {vg_launches}")

    # -- the main path: the fit to the released counts, and the ensemble
    hm.reset_free()
    nominal = float(value_fn(cd.current_rescaled_values()))
    reset_launch_counts(chain)
    torch.cuda.reset_peak_memory_stats()

    def fit():
        hm.reset_free()
        return Analysis().fit_recursively(data, hm, "mod_chi2", None,
                                          "device", {}, None)

    t0 = time.perf_counter()
    fit()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sources = {}
    waits, result = count_host_syncs(fit, sources)
    torch.cuda.synchronize()
    fit_wall = time.perf_counter() - t0
    meta = result.minimizer_metadata
    print(f"Analysis fit to the released counts, device, float32: wall"
          f" {fit_wall:.3f} s (first run with set-up and capture"
          f" {first_s:.2f} s), nit {meta['nit']}, nfev {meta['nfev']},"
          f" {waits} waits for the card ({waits / meta['nfev']:.2f} per"
          f" evaluation), mod_chi2 {result.metric_val!r} (at the nominal"
          f" values {nominal!r}) [{smi}]")
    for where, count in sorted(sources.items(), key=lambda x: -x[1])[:6]:
        print(f"  {count:5d} waits at {where}")
    for name in ("theta23", "deltam31", "atm_muon_scale", "daemon_pi_31G"):
        print(f"  {name:16s} best fit {result.params[name].value}")
    check(np.isfinite(result.metric_val)
          and result.metric_val < nominal,
          "the fit to the released counts did not lower mod_chi2")
    check(waits / meta["nfev"] <= DEVICE_FIT_WAITS,
          f"the release fit waited {waits / meta['nfev']:.2f} times per"
          " evaluation")
    hm.reset_free()
    t0 = time.perf_counter()
    ens = fit_pseudo_ensemble(cd, "mod_chi2", n_trials=RELEASE_TRIALS,
                              seed=0, max_steps=RELEASE_MAX_STEPS)
    wall = time.perf_counter() - t0
    launches = launch_counts(chain)
    nit = ens["nit"]
    print(f"fit_pseudo_ensemble, {RELEASE_TRIALS} trials, release hypothesis,"
          f" float32: wall {wall:.3f} s with the capture of its"
          f" {RELEASE_TRIALS}-lane objective"
          f" ({wall / RELEASE_TRIALS * 1e3:.2f} ms a lane), nit median"
          f" {float(np.median(nit))} max {int(nit.max())} min {int(nit.min())},"
          f" {ens['nfev']} evaluations, {ens['reads']} flag reads; peak memory"
          f" (fit and ensemble) {torch.cuda.max_memory_allocated() / 2**20:.1f}"
          f" MiB; launches (primal, tangent, multitangent) of the fit and the"
          f" ensemble {launches} [{smi}]")
    check(launches[0] > 0 and launches[2] > 0,
          "a kernel of the release path never ran")
    check(np.all(np.isfinite(ens["fun"])) and np.all(nit > 0)
          and np.all(np.isfinite(ens["magnitudes"])),
          "the release ensemble's fits are not all finite")
    value_0, _ = cd.build_objective(ens["data"][0], "mod_chi2")
    x_nom = cd.current_rescaled_values()
    value_0.raw(torch.as_tensor(x_nom, device="cuda"), los, his)  # capture
    t0 = time.perf_counter()
    solo = minimize_on_device(value_0.raw, x_nom, *cd._current_bounds(),
                              max_steps=RELEASE_MAX_STEPS, device="cuda")
    solo_wall = time.perf_counter() - t0
    print(f"solo minimize_on_device, trial 0's data, same start, float32:"
          f" wall {solo_wall:.3f} s, nit {solo['nit']} (lane 0: {int(nit[0])}),"
          f" {solo['nfev']} evaluations; the ensemble took"
          f" {wall / solo_wall:.2f} solo fits' wall for {RELEASE_TRIALS} fits"
          f" [{smi}]")
    BasicAnalysis._compiled_cache.clear()
    del hm, cd
    return launches


# -- the rest of the analysis layer, float32 -------------------------------------
def time_captured_vg(label, value_fn, vg, v, bounds, smi):
    """Wall (median of 10, with its one read), back-to-back time, waits,
    kernels per replay and busy share of a captured value_and_grad."""
    import torch

    waits, _ = count_host_syncs(lambda: read_back(vg(v)))
    wall, wall_min = median_wall(lambda: read_back(vg(v)), 10)
    program = value_fn.program
    vec = torch.as_tensor(v, device="cuda")
    back_ms = cuda_time(lambda: program.value_and_grad(vec, *bounds), 20)
    profiled = [profile_device_busy(
        lambda: program.value_and_grad(vec, *bounds)) for _ in range(2)]
    _, device_ms, _, _, kernels = profiled[-1]
    print(f"float32 {label}, captured value_and_grad: wall"
          f" {wall * 1e3:.3f} ms median of 10 (min {wall_min * 1e3:.3f}),"
          f" {back_ms:.3f} ms back to back, {waits} wait(s); one replay:"
          f" {kernels} kernels, {device_ms:.3f} ms of device time"
          f" ({100 * device_ms / (wall * 1e3):.1f}% busy of the median wall)"
          f" [{smi}]")
    check(waits == 1, f"{label}: value_and_grad waited {waits} times")


def metrics_fp32(pipeline, chain, smi):
    """float32, the flagship at full width on the card: each MC-uncertainty
    metric's captured value_and_grad through CompiledDistribution (nonzero
    data variance) and mcllh_eff through the template's sum_maps objective,
    timed; then, with the counts set to 0 just before and read just after,
    a device fit through Analysis under mcllh_eff and two nlopt fits (one
    derivative-free name with theta23 alone free, one gradient name with
    every param free), each from theta23 + 0.10 rescaled and each held to
    recover theta23 within FIT_TOL. Returns the fits' launches."""
    import numpy as np
    import torch

    from pisa_tpu_torch.analysis.analysis import Analysis, BasicAnalysis
    from pisa_tpu_torch.analysis.gradient import CompiledDistribution
    from pisa_tpu_torch.core.distribution_maker import DistributionMaker

    cd = CompiledDistribution(pipeline)
    ct = pipeline.compile()
    nominal = ct.current_rescaled_values()
    data = cd.sum_hist(nominal)
    var = small_grid_variance(data)
    v = gradient_point(ct)
    for label, build, owner in [
            (m, lambda m=m: cd.build_objective(data, m, data_variance=var),
             cd) for m in MC_METRICS] + [
            ("mcllh_eff, sum_maps", lambda: ct.build_objective(
                ct.get_outputs(nominal), "mcllh_eff", sum_maps=True), ct)]:
        t0 = time.perf_counter()
        value_fn, vg = build()
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        value, grad = vg(v)
        check(np.isfinite(float(value))
              and bool(torch.isfinite(grad).all()), f"{label}: not finite")
        print(f"float32 {label}: value {float(value)!r}; build and capture"
              f" {built:.2f} s")
        time_captured_vg(label, value_fn, vg, v, owner._device_bounds(), smi)
    del cd, ct

    reset_launch_counts(chain)
    dm = DistributionMaker([CFG], device="cuda")
    asimov = dm.get_outputs(return_sum=True)
    truth = dm.params["theta23"]._rescaled_value
    fits = (
        ("device, mcllh_eff", "mcllh_eff", "device", {}, False),
        ("nlopt LN_NELDERMEAD, theta23 alone free", "mod_chi2", "nlopt",
         {"algorithm": "LN_NELDERMEAD", "ftol_abs": 1e-6, "maxeval": 200},
         True),
        ("nlopt LD_LBFGS", "mod_chi2", "nlopt",
         {"algorithm": "LD_LBFGS", "ftol_abs": 1e-9, "maxeval": 500}, False),
    )
    for label, metric, method, kwargs, alone in fits:
        dm.reset_free()
        others = [p for p in dm.params.free if p.name != "theta23"]
        if alone:
            for p in others:
                p.is_fixed = True
        try:
            dm.params["theta23"]._rescaled_value = min(0.95, truth + 0.10)
            t0 = time.perf_counter()
            result = Analysis().fit_recursively(asimov, dm, metric, None,
                                                method, dict(kwargs), None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            for p in others:
                p.is_fixed = False
        meta = result.minimizer_metadata
        moved = result.params["theta23"]._rescaled_value - truth
        print(f"Analysis fit, {label}, float32: wall {wall:.3f} s (with"
              f" set-up and capture), nit {meta['nit']}, nfev {meta['nfev']},"
              f" method {meta['method']}, theta23 off by {moved:.3e}"
              f" rescaled (bound {FIT_TOL:g}), metric {result.metric_val!r}"
              f" [{smi}]")
        check(abs(moved) <= FIT_TOL, f"the {label} fit did not recover"
              " theta23")
    launches = launch_counts(chain)
    print(f"metrics path launches (the three fits): primal {launches[0]},"
          f" tangent {launches[1]}, multitangent {launches[2]} [{smi}]")
    check(launches[0] > 0 and launches[2] > 0,
          "a kernel of the metrics path never ran")
    BasicAnalysis._compiled_cache.clear()
    return launches


def fisher_fp32(pipeline, chain, smi):
    """float32, the flagship at full width: get_fisher_matrix (one
    torch.func.jacfwd of the stacked eager template), with the counts set
    to 0 just before and read just after, held to the vmap rule's count
    (one primal and one multitangent launch per sign: the 15 directions
    become the 3 active columns of one pass); its Jacobian against central
    differences of the captured template (FISHER_FD); one direction's jvp
    (one tangent launch per sign) against its column; the pulls."""
    import numpy as np
    import torch

    from pisa_tpu_torch.analysis.fisher import (
        _template_jacobian,
        calculate_pulls,
        get_fisher_matrix,
    )

    ct = pipeline.compile()
    v = ct.current_rescaled_values()
    reset_launch_counts(chain)
    t0 = time.perf_counter()
    fm = get_fisher_matrix(ct)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fisher_launches = launch_counts(chain)
    t0 = time.perf_counter()
    mu, jac = _template_jacobian(ct, v)
    torch.cuda.synchronize()
    jac_wall = time.perf_counter() - t0
    print(f"float32 Fisher matrix, flagship ({len(fm.parameters)} params,"
          f" {mu.size} bins): get_fisher_matrix {wall:.3f} s (first, with"
          f" the geometry's forward-mode set-up), jacfwd again"
          f" {jac_wall * 1e3:.1f} ms; launches (primal, tangent,"
          f" multitangent) {fisher_launches} [{smi}]")
    check(fisher_launches == (2, 0, 2),
          f"jacfwd launches {fisher_launches}, the vmap rule predicts"
          " (2, 0, 2)")
    check(np.all(np.isfinite(fm.matrix)), "Fisher matrix not finite")

    def total(x):
        out = ct(x)["hist"]
        return torch.cat([out[n] for n in sorted(out)]).double().cpu().numpy()

    def central(i, h):
        vp, vm = v.copy(), v.copy()
        vp[i] = min(1.0, v[i] + h)
        vm[i] = max(0.0, v[i] - h)
        return (total(vp) - total(vm)) / (vp[i] - vm[i])

    worst = 0.0
    h = FISHER_FD["step"]
    for i, name in enumerate(ct.free_names):
        # Richardson's extrapolation of steps h and h/2: the truncation
        # goes as h^4 (deltam31's columns curve too much for h^2 at a step
        # the float32 rounding allows)
        fd = (4.0 * central(i, h / 2) - central(i, h)) / 3.0
        bound = (FISHER_FD["rtol"] * np.abs(jac[:, i]).max()
                 + 3.0 * FISHER_FD["noise"] * np.abs(mu).max() / h)
        err = np.abs(fd - jac[:, i]).max() / bound
        worst = max(worst, err)
        check(err <= 1.0, f"Jacobian column {name} vs central differences:"
              f" {err:.3e} of its bound")
    print(f"float32 Jacobian vs central differences of the captured template"
          f" (steps {h:g} and {h / 2:g} rescaled, extrapolated): worst column"
          f" at {worst:.3e} of its bound")

    # one direction: OscProbs.jvp, one tangent launch per sign
    i23 = ct.free_names.index("theta23")
    los, his = ct._device_bounds()

    def hist_of(x):
        out = ct._evaluate(ct._magnitudes_from_rescaled(x, los, his))
        return torch.cat([out["hist"][n] for n in sorted(out["hist"])])

    direction = torch.zeros(len(v), dtype=torch.float64, device="cuda")
    direction[i23] = 1.0
    reset_launch_counts(chain)
    _, column = torch.func.jvp(
        hist_of, (torch.as_tensor(v, device="cuda"),), (direction,))
    jvp_launches = launch_counts(chain)
    err = rel_max(column.double().cpu().numpy(), jac[:, i23])
    print(f"float32 jvp along theta23: launches {jvp_launches}, against the"
          f" jacfwd column {err:.3e} of its largest entry [{smi}]")
    check(jvp_launches == (2, 2, 0), f"jvp launches {jvp_launches}")
    check(err <= 1e-5, "jvp vs jacfwd column")
    shifted = {n: h.cpu().numpy() for n, h in ct(gradient_point(ct))[
        "hist"].items()}
    pulls = calculate_pulls(ct, shifted)
    print(f"float32 pulls toward the gradient point: theta23"
          f" {pulls['theta23']:.5g}, aeff_scale {pulls['aeff_scale']:.5g}")
    check(all(np.isfinite(p) for p in pulls.values()), "pulls not finite")
    return tuple(a + b for a, b in zip(fisher_launches, jvp_launches))


def mcmc_fp32(pipeline, chain, smi):
    """float32, the flagship at full width: mcmc_sampling with MCMC_WALKERS
    walkers (MCMC_WALKERS/2 lanes of one captured program),
    MCMC_BURNIN burn-in and MCMC_STEPS recorded steps against the Asimov
    data, beside the same call with one step: the difference is the other
    steps' wall and waits for the card (held to 0 per step: the one read is at
    the end). The counts are set to 0 just before the sampling run and read
    just after; a replay does not advance them."""
    import numpy as np

    from pisa_tpu_torch.analysis.bayesian import mcmc_sampling

    ct = pipeline.compile()
    data = ct.get_outputs(ct.current_rescaled_values())
    kwargs = dict(metric="llh", n_walkers=MCMC_WALKERS, seed=0,
                  init_spread=0.01)
    runs = {}
    for label, burn, steps in (("one step", 0, 1),
                               ("run", MCMC_BURNIN, MCMC_STEPS)):
        if label == "run":
            reset_launch_counts(chain)
        t0 = time.perf_counter()
        waits, out = count_host_syncs(lambda: mcmc_sampling(
            ct, data, n_burnin=burn, n_steps=steps, **kwargs))
        runs[label] = (time.perf_counter() - t0, waits, out)
    launches = launch_counts(chain)
    (wall0, waits0, _), (wall, waits, (samples, logp, acceptance)) = (
        runs["one step"], runs["run"])
    n = MCMC_BURNIN + MCMC_STEPS - 1
    per_step = (wall - wall0) / n
    step_waits = (waits - waits0) / n
    print(f"float32 MCMC, flagship, {MCMC_WALKERS} walkers, {MCMC_BURNIN}"
          f" burn-in + {MCMC_STEPS} steps: {per_step * 1e3:.2f} ms per step"
          f" (two half-ensemble replays of {MCMC_WALKERS // 2} lanes),"
          f" acceptance {acceptance:.3f}, {step_waits:g} host waits per step"
          f" ({waits} in the run, {waits0} in a run of one step); launches"
          f" (primal, tangent, multitangent) at the capture of the"
          f" {MCMC_WALKERS // 2}-lane program {launches}; wall {wall:.2f} s"
          f" [{smi}]")
    check(samples.shape == (MCMC_STEPS, MCMC_WALKERS,
                            len(ct.free_names)), "chain shape")
    check(np.all(np.isfinite(samples)) and np.all(np.isfinite(logp)),
          "MCMC chain not finite")
    check(np.all((samples >= 0) & (samples <= 1)), "walkers left the box")
    check(0.0 < acceptance < 1.0, f"acceptance {acceptance}")
    check(step_waits == 0, f"{step_waits} waits per MCMC step")
    check(launches[0] > 0, "the primal kernel never ran for the walkers")
    return launches



# -- prob3's physics options: NSI, decay, LRI, tomography, dedup, events ------
def general_pack_cases(params):
    """The general packs the kernels are held at: (label, theta, NSI
    couplings (the 9 eps_* of StdNSIParams), v_lri of the mutau symmetry).
    'moderate' is near the couplings IceCube probes; 'large' is ten times
    beyond, where matter and NSI dominate the Hamiltonian."""
    theta = flagship_thetas(params, 2)
    moderate = dict(NSI_NOMINAL, eps_ee=0.1, eps_emu_magn=0.03,
                    eps_emu_phase=0.4, eps_mutau_magn=0.05,
                    eps_mutau_phase=0.7)
    large = dict(NSI_NOMINAL, eps_ee=0.5, eps_emu_magn=0.3,
                 eps_emu_phase=1.2, eps_etau_magn=0.3, eps_etau_phase=-0.8,
                 eps_mutau_magn=0.5, eps_mutau_phase=2.1, eps_tautau=0.4)
    return [("moderate", theta[0], moderate, 2e-14),
            ("moderate", theta[1], moderate, -1e-14),
            ("large", theta[0], large, 5e-14)]


def general_pack(chain, theta, eps, v_lri, nubar):
    """The float64 pack (57,) of the general physics (NSI couplings `eps`,
    mutau LRI `v_lri`) and its derivatives along (theta13, theta23, dm31,
    eps_mutau_magn, eps_mutau_phase, v_lri) as (6, 57), on the CPU."""
    import torch

    from pisa_tpu_torch.ops.osc.nonstandard import lri_potential, std_nsi_eps
    from pisa_tpu_torch.ops.osc.pmns import dm_matrix, pmns_matrix

    def pack(x):
        t13, t23, dm31, magn, phase, v = x.unbind()
        t12, dcp, dm21 = (torch.full((), float(theta[i]), dtype=torch.float64)
                          for i in (0, 3, 4))
        mix = pmns_matrix(torch.sin(t12), torch.sin(t13), torch.sin(t23), dcp)
        U = mix if nubar > 0 else torch.complex(mix.real, -mix.imag)
        couplings = [eps[n] for n in NSI_NAMES]
        couplings[6], couplings[7] = magn, phase
        mat_pot = torch.zeros((3, 3), dtype=torch.complex128)
        mat_pot[0, 0] = 1.0
        mat_pot = mat_pot + std_nsi_eps(*couplings)
        # v_lri in units of 1e-14 eV, so that the directions are O(1)
        lri = lri_potential(v * 1e-14, "mutau-symmetry")
        return chain.pack_from_physics(dm_matrix(dm21, dm31), U, mat_pot, lri,
                                       nubar)

    x = torch.tensor([theta[1], theta[2], theta[5], eps["eps_mutau_magn"],
                      eps["eps_mutau_phase"], v_lri / 1e-14],
                     dtype=torch.float64)
    return pack(x), torch.func.jacfwd(pack)(x).T.contiguous()


def general_pack_kernels(chain):
    """The three kernels against their plain versions at general packs
    (complex off-diagonal M_eff from NSI, nonzero L_eff from LRI;
    general_pack_cases), nu and nubar, float64 and float32, on the flagship
    geometry: the primal (KERNEL_ATOL), the tangent along the 3 coupling
    directions (TANGENT_RTOL, relative to each direction's largest) and the
    multitangent at K = 3 over them and K = 6 over all six (primal
    MULTI_PRIMAL_ATOL, tangents TANGENT_RTOL). Every case is held at the
    bounds, except the float32 primal kernel's error at the 'large' case:
    where that exceeds its bound, the error and couplings are printed and
    the run goes on (PERF.md section 7). Returns {dtype: worst primal
    error} over the held cases."""
    import torch

    worst_held = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        geom, params = flagship_geometry(dtype)
        args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
        tiles = geom["tiles"]
        worst_held[dname] = 0.0
        for label, theta, eps, v_lri in general_pack_cases(params):
            for nubar in (1, -1):
                pvec64, dirs64 = general_pack(chain, theta, eps, v_lri, nubar)
                pvec = pvec64.to("cuda", dtype)
                dirs = dirs64.to("cuda", dtype)
                got = chain.chain_probs(pvec, *args, tiles)
                ref = chain.chain_probs_reference(pvec, *args)
                exact = chain.chain_probs_reference(pvec64.to("cuda"), *(
                    a.double() if a.is_floating_point() else a for a in args))
                t_errs = []
                for d in dirs[3:]:
                    tg = chain.chain_tangent(pvec, d.contiguous(), *args,
                                             tiles)
                    tr = chain.chain_tangent_reference(pvec, d, *args)
                    t_errs.append(float((tg - tr).abs().max()
                                        / tr.abs().max()))
                m_errs = []
                for pick in (dirs[3:].contiguous(), dirs):
                    out, dout = chain.chain_multitangent(pvec, pick, *args,
                                                         tiles)
                    rp, rt = chain.chain_multitangent_reference(pvec, pick,
                                                                *args)
                    scale = rt.abs().amax(dim=(1, 2, 3), keepdim=True)
                    m_errs.append((float((out - rp).abs().max()),
                                   float(((dout - rt).abs() / scale).max())))
                torch.cuda.synchronize()
                finite = all(bool(torch.isfinite(x).all())
                             for x in (got, out, dout))
                p_err = float((got - ref).abs().max())
                t_err = max(t_errs)
                mp_err = max(e[0] for e in m_errs)
                mt_err = max(e[1] for e in m_errs)
                over = (p_err > KERNEL_ATOL[dname]
                        or mp_err > MULTI_PRIMAL_ATOL[dname]
                        or max(t_err, mt_err) > TANGENT_RTOL[dname])
                print(f"general pack {label} (eps_mutau {eps['eps_mutau_magn']:g}"
                      f" e^{eps['eps_mutau_phase']:g}i, eps_ee"
                      f" {eps['eps_ee']:g}, v_lri {v_lri:g} eV), nubar"
                      f" {nubar:+d}, {dname}: primal vs plain {p_err:.3e}"
                      f" (bound {KERNEL_ATOL[dname]:g}; vs float64 plain"
                      f" {float((got.double() - exact).abs().max()):.3e});"
                      f" tangent {t_err:.3e}, multitangent K=3/6 primal"
                      f" {mp_err:.3e}, tangents {mt_err:.3e} (bound"
                      f" {TANGENT_RTOL[dname]:g} rel)"
                      + (" EXCEEDS A BOUND" if over else ""))
                check(finite, f"general pack {label}: kernel output not finite")
                check(mp_err <= MULTI_PRIMAL_ATOL[dname]
                      and max(t_err, mt_err) <= TANGENT_RTOL[dname],
                      f"general pack {label}, {dname}: tangent or"
                      f" multitangent kernel off its plain version ({t_err},"
                      f" {mp_err}, {mt_err})")
                worst_held[dname] = max(worst_held[dname], mp_err)
                if p_err <= KERNEL_ATOL[dname]:
                    worst_held[dname] = max(worst_held[dname], p_err)
                elif label == "large" and dtype == torch.float32:
                    print(f"  float32 primal at large couplings beyond its"
                          f" bound: {p_err:.3e} at eps {eps}, v_lri"
                          f" {v_lri:g} eV (not held)")
                else:
                    check(False, f"general pack {label}, {dname}: primal"
                          f" kernel off its plain version by {p_err}")
    return worst_held


def options_config(option, small=False, fraction=None, earth_model=None):
    """The flagship config with one of prob3's options: 'nsi' (standard,
    the 9 eps_* at NSI_NOMINAL with eps_mutau_magn free: 16 free params),
    'decay' (decay_alpha3 free at 0), 'events' (prob3 and barr_simple at
    calc_mode = events), 'lri' (mutau, v_lri fixed), 'lri-emu' (emu,
    v_lri free: 16 free params), 'tomography-earth',
    'tomography-core', 'tomography-core-free' (the latter two on the
    5-layer model at `earth_model`), 'dedup'. `small`: the 20x20 grid;
    `fraction`: the loader keeps that fraction of the events."""
    from pisa_tpu_torch import ureg
    from pisa_tpu_torch.config.parser import parse_pipeline_config
    from pisa_tpu_torch.core.param import Param, ParamSet

    config = small_grid_config() if small else parse_pipeline_config(CFG)
    if fraction is not None:
        config[("data", "csv_loader")]["fraction_events_to_keep"] = fraction
    section = config[("osc", "prob3")]
    extra = []
    if option == "nsi":
        section["nsi_type"] = "standard"
        for name in NSI_NAMES:
            unit = ureg.rad if name.endswith("phase") else ureg.dimensionless
            extra.append(Param(name=name, value=NSI_NOMINAL[name] * unit,
                               range=(-0.1, 0.1) * unit,
                               is_fixed=name != "eps_mutau_magn"))
    elif option == "decay":
        section["neutrino_decay"] = True
        extra.append(Param(name="decay_alpha3", value=0.0 * ureg.eV ** 2,
                           range=(0.0, 1e-3) * ureg.eV ** 2, is_fixed=False))
    elif option == "events":
        for key in (("flux", "barr_simple"), ("osc", "prob3")):
            config[key]["calc_mode"] = "events"
    elif option == "lri":
        section["lri_type"] = "mutau-symmetry"
        extra.append(Param(name="v_lri", value=2e-14 * ureg.eV,
                           range=(0.0, 1e-13) * ureg.eV, is_fixed=True))
    elif option == "lri-emu":
        section["lri_type"] = "emu-symmetry"
        extra.append(Param(name="v_lri", value=2e-14 * ureg.eV,
                           range=(0.0, 1e-13) * ureg.eV, is_fixed=False))
    elif option.startswith("tomography"):
        kind, scales = {
            "tomography-earth": ("mass_of_earth", {"density_scale": 1.02}),
            "tomography-core": ("mass_of_core_w_constrain",
                                {"core_density_scale": 1.05}),
            "tomography-core-free": ("mass_of_core_wo_constrain",
                                     {"core_density_scale": 1.05,
                                      "innermantle_density_scale": 0.97,
                                      "middlemantle_density_scale": 1.01}),
        }[option]
        section["tomography_type"] = kind
        extra += [Param(name=n, value=v * ureg.dimensionless, is_fixed=True)
                  for n, v in scales.items()]
        if option != "tomography-earth":
            extra.append(Param(name="earth_model", value=earth_model,
                               is_fixed=True))
    elif option == "dedup":
        section["layer_dedup"] = True
    else:
        raise ValueError(f"unknown option {option!r}")
    section["params"].update(ParamSet(extra))
    return config


def write_five_layer_model(directory):
    """The 5-layer Earth model the core tomography types require, as a
    PREM table in `directory`; returns its path."""
    import numpy as np

    from pisa_tpu_torch.ops.osc.nonstandard import (
        FIVE_LAYER_RADII_KM,
        FIVE_LAYER_RHOS,
    )

    path = os.path.join(directory, "PREM_5layer.dat")
    np.savetxt(path, np.stack([FIVE_LAYER_RADII_KM, FIVE_LAYER_RHOS], axis=1))
    return path


def osc_options_fp64(smi):
    """float64, card against CPU: the value_and_grad of mod_chi2 (Asimov
    data at nominal, at gradient_point) for (a) NSI with eps_mutau_magn
    free and (b) decay with decay_alpha3 free on the 20x20-grid flagship,
    and (c) the per-event calc mode (stacked) at OPTIONS_FP64_FRACTION of
    the events (the grid does not enter it; the CPU's plain tangents at
    all 240k events would take minutes); the card's captured objective
    within VG_FP64 of the CPU's."""
    import numpy as np

    from pisa_tpu_torch.core.pipeline import Pipeline

    for option, fraction in (("nsi", None), ("decay", None),
                             ("events", OPTIONS_FP64_FRACTION)):
        results = {}
        for device in ("cpu", "cuda"):
            t0 = time.perf_counter()
            ct = Pipeline(options_config(option, small=True,
                                         fraction=fraction),
                          device=device).compile()
            data = ct.get_outputs(ct.current_rescaled_values())
            _, vg = ct.build_objective(data, "mod_chi2")
            value, grad = vg(gradient_point(ct))
            results[device] = (float(value), grad.cpu().numpy(),
                               time.perf_counter() - t0, ct.stacked)
        (want, want_g, cpu_s, _), (got, got_g, card_s, stacked) = (
            results["cpu"], results["cuda"])
        rel = abs(got - want) / abs(want)
        mism = grad_mismatch(got_g, want_g, VG_FP64["grad_rtol"],
                             VG_FP64["grad_atol"])
        print(f"float64 {option} ({'stacked' if stacked else 'per container'},"
              f" {len(got_g)} free), card vs CPU: value {got!r} vs {want!r}"
              f" ({rel:.3e} relative, bound {VG_FP64['value']:g}); gradient"
              f" {rel_max(got_g, want_g):.3e} of max|g|, worst entry at"
              f" {mism:.3e} of its bound (rtol {VG_FP64['grad_rtol']:g}); set-up"
              f" and one value_and_grad {card_s:.1f} s on the card,"
              f" {cpu_s:.1f} s on the CPU [{smi}]")
        check(np.isfinite(got) and np.all(np.isfinite(got_g)),
              f"{option}: not finite on the card")
        check(rel <= VG_FP64["value"], f"{option}: card value vs CPU")
        check(mism <= 1.0, f"{option}: card gradient vs CPU")


def osc_options_worker():
    """float64: osc_options_fp64 in a child process."""
    from pisa_tpu_torch import FTYPE_NAME

    check(FTYPE_NAME == "fp64", f"options worker runs {FTYPE_NAME}")
    smi = card_line()
    t0 = time.perf_counter()
    osc_options_fp64(smi)
    print(f"float64 options phase: {time.perf_counter() - t0:.1f} s [{smi}]")


def measure_vg(label, ct, chain, smi):
    """The compiled template's mod_chi2 at full width, float32 (Asimov data
    at nominal, at gradient_point): the launches of one eager
    value_and_grad, then the captured one's wall (median of 10 with its
    read), back-to-back time, waits, kernels per replay, busy share and peak
    memory. Returns the eager launches."""
    import numpy as np
    import torch

    data = ct.get_outputs(ct.current_rescaled_values())
    v = gradient_point(ct)
    _, eager = ct.build_objective(data, "mod_chi2", capture=False)
    reset_launch_counts(chain)
    value, grad = eager(torch.as_tensor(v, device="cuda"))
    torch.cuda.synchronize()
    eager_launches = launch_counts(chain)
    eager_vg = (float(value), grad.cpu().numpy())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    value_fn, vg = ct.build_objective(data, "mod_chi2")
    got = read_back(vg(v))
    capture_s = time.perf_counter() - t0
    check(np.all(np.isfinite(got)), f"{label}: value_and_grad not finite")
    check(abs(got[0] - eager_vg[0]) <= STACKED_FP32["value"] * abs(eager_vg[0])
          and rel_max(got[1:], eager_vg[1]) <= STACKED_FP32["grad"],
          f"{label}: the captured value_and_grad is off the eager one")
    waits, _ = count_host_syncs(lambda: read_back(vg(v)))
    wall, wall_min = median_wall(lambda: read_back(vg(v)), 10)
    program = value_fn.program
    bounds = ct._device_bounds()
    vec = torch.as_tensor(v, device="cuda")
    # the replay alone, without the read of its result
    replay_waits, _ = count_host_syncs(
        lambda: program.value_and_grad(vec, *bounds))
    back_ms = cuda_time(lambda: program.value_and_grad(vec, *bounds), 20)
    profiled = [profile_device_busy(
        lambda: program.value_and_grad(vec, *bounds)) for _ in range(2)]
    _, device_ms, top, _, kernels = profiled[-1]
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    print(f"float32 {label} ({len(ct.free_names)} free,"
          f" {'stacked' if ct.stacked else 'per container'}), captured"
          f" value_and_grad: wall {wall * 1e3:.3f} ms median of 10 (min"
          f" {wall_min * 1e3:.3f}), {back_ms:.3f} ms back to back, {waits}"
          f" wait(s); one replay: {kernels} kernels, {device_ms:.3f} ms of"
          f" device time ({100 * device_ms / (wall * 1e3):.1f}% busy of the"
          f" median wall); peak memory above what was resident {peak:.1f}"
          f" MiB; capture with its first call {capture_s:.2f} s; launches"
          f" (primal, tangent, multitangent) of one eager value_and_grad"
          f" {eager_launches}; waits inside one replay {replay_waits}"
          f" [{smi}]")
    for key, ms, count in top[:5]:
        print(f"  {ms:8.3f} ms  {count:5d}x  {key[:80]}")
    check(waits == 1, f"{label}: value_and_grad waited {waits} times")
    check(replay_waits == 0, f"{label}: the replay waited {replay_waits}"
          " times")
    return eager_launches


def per_event_kernels(chain, pipeline, ct, smi):
    """The primal and the multitangent kernel (K = 3) against their plain
    versions at the shapes the per-event calc mode gives them: each nubar
    group's (categories x padded events) geometry that prob3 built for the
    compiled template's stacked container (the padded points' chains have
    zero length), with the pack of the pipeline's theta and its 3 free
    directions; primal KERNEL_ATOL, multitangent primal MULTI_PRIMAL_ATOL
    and tangents TANGENT_RTOL (relative to each direction's largest). Then
    each kernel's device-only time there beside its plain version's and its
    bound. These launches are not the path's: the counts are reset after."""
    import torch

    prob3 = next(s for s in pipeline.stages if type(s).__name__ == "prob3")
    static = prob3._stacked_events_geometry(ct._trace_data.containers[0])
    params = {name: pipeline.params[name] for name in (
        "theta12", "theta13", "theta23", "deltacp", "deltam21", "deltam31")}
    theta = flagship_thetas(params, 1)[0]
    for sign, geom in static["groups"]:
        dtype = geom["e"].dtype
        dname = str(dtype).split(".")[-1]
        args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
        tiles = geom["tiles"]
        pvec, dirs = pack_and_directions(chain, theta, sign, dtype)
        dpvecs = dirs[list(FREE_THETA)].contiguous()
        got = chain.chain_probs(pvec, *args, tiles)
        ref = chain.chain_probs_reference(pvec, *args)
        out, dout = chain.chain_multitangent(pvec, dpvecs, *args, tiles)
        ref_p, ref_t = chain.chain_multitangent_reference(pvec, dpvecs, *args)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(x).all()) for x in (got, out, dout)),
              f"per-event kernels, nubar {sign:+d}: output not finite")
        scale = ref_t.abs().amax(dim=(1, 2, 3), keepdim=True)
        p_err = float((got - ref).abs().max())
        mp_err = float((out - ref_p).abs().max())
        mt_err = float(((dout - ref_t).abs() / scale).max())
        n = geom["e"].shape[0]
        times = {
            "primal": graph_time(lambda: chain.chain_probs(pvec, *args,
                                                           tiles), 20),
            "primal plain": cuda_time(
                lambda: chain.chain_probs_reference(pvec, *args), 3),
            "multitangent": graph_time(lambda: chain.chain_multitangent(
                pvec, dpvecs, *args, tiles), 20),
            "multitangent plain": cuda_time(
                lambda: chain.chain_multitangent_reference(pvec, dpvecs,
                                                           *args), 2),
        }
        bounds = (kernel_bound(chain, geom, 0, True),
                  kernel_bound(chain, geom, 3, True))
        print(f"per-event kernels, nubar {sign:+d}, {dname}, N={n} points"
              f" ({int((geom['nl'] == 0).sum())} with no layer step), L="
              f"{geom['dens'].shape[0]}, {tile_line(tiles)}: primal vs plain"
              f" {p_err:.3e} (bound {KERNEL_ATOL[dname]:g}); multitangent"
              f" K=3 primal {mp_err:.3e} (bound {MULTI_PRIMAL_ATOL[dname]:g}),"
              f" tangents {mt_err:.3e} (bound {TANGENT_RTOL[dname]:g} rel);"
              f" device-only primal {times['primal']:.5f} ms (plain"
              f" {times['primal plain']:.3f} ms, bound"
              f" {bounds[0]['bound_ms']:.5f} ms by {bounds[0]['bound_by']}),"
              f" multitangent {times['multitangent']:.5f} ms (plain"
              f" {times['multitangent plain']:.3f} ms, bound"
              f" {bounds[1]['bound_ms']:.5f} ms by {bounds[1]['bound_by']})"
              f" [{smi}]")
        check(p_err <= KERNEL_ATOL[dname] and mp_err <= MULTI_PRIMAL_ATOL[dname]
              and mt_err <= TANGENT_RTOL[dname],
              f"per-event kernels, nubar {sign:+d}: off their plain versions"
              f" ({p_err}, {mp_err}, {mt_err})")


def osc_options_fp32(chain, smi):
    """prob3's options on the card at full width, float32, through the
    entry points a user calls (this slice's main path): (a) NSI with the 9
    eps_* and eps_mutau_magn free: the captured value_and_grad, then a
    `device` fit through Analysis from theta23 and eps_mutau_magn moved by
    +0.10 rescaled off the Asimov truth; (b) decay with decay_alpha3 free:
    the template and the captured value_and_grad (finite at float32); (c)
    prob3 and barr_simple at calc_mode = events, stacked, at 240k events:
    the template and the captured value_and_grad, then the kernels held
    against their plain versions at its shapes (per_event_kernels); (d)
    LRI, the three tomography types and layer dedup: the template. The
    launch counts are set to 0 just before each path and read just after;
    returns their sums."""
    import numpy as np
    import torch

    from pisa_tpu_torch.analysis.analysis import Analysis, BasicAnalysis
    from pisa_tpu_torch.core.distribution_maker import DistributionMaker
    from pisa_tpu_torch.core.pipeline import Pipeline

    total = [0, 0, 0]

    def add(launches):
        for i, n in enumerate(launches):
            total[i] += n

    expected = {"nsi": (2, 0, 0), "decay": (0, 0, 0),
                "events": expected_vg_launches(True)}
    with tempfile.TemporaryDirectory() as tmp:
        earth = write_five_layer_model(tmp)
        for option in ("nsi", "decay", "events", "lri", "tomography-earth",
                       "tomography-core", "tomography-core-free", "dedup"):
            reset_launch_counts(chain)
            t0 = time.perf_counter()
            pipeline = Pipeline(options_config(option, earth_model=earth),
                                device="cuda")
            setup_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            maps = pipeline.get_outputs()
            totals = [float(m.hist.sum()) for m in maps]
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            check(all(np.isfinite(t) and t > 0 for t in totals),
                  f"{option}: template not finite")
            walls = []
            for _ in range(5):
                pipeline.params["theta23"].value = (
                    pipeline.params["theta23"].value * 1.001)
                t0 = time.perf_counter()
                pipeline.get_outputs()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            launches = launch_counts(chain)
            print(f"float32 {option}: Pipeline set-up {setup_s:.2f} s, first"
                  f" template {first_s:.2f} s, then get_outputs median"
                  f" {np.median(walls) * 1e3:.2f} ms (5 runs), {sum(totals):.1f}"
                  f" expected events; launches {launches} [{smi}]")
            add(launches)
            if option in expected:
                ct = pipeline.compile()
                check(ct.stacked, f"{option}: the template did not stack")
                reset_launch_counts(chain)
                vg_launches = measure_vg(option, ct, chain, smi)
                check(vg_launches == expected[option],
                      f"{option}: value_and_grad launches {vg_launches}")
                add(launch_counts(chain))
                if option == "events":
                    per_event_kernels(chain, pipeline, ct, smi)
                    reset_launch_counts(chain)
                del ct
            del pipeline, maps

    # (a) the NSI fit through the analysis layer
    reset_launch_counts(chain)
    t0 = time.perf_counter()
    dm = DistributionMaker([options_config("nsi")], device="cuda")
    data = dm.get_outputs(return_sum=True)
    print(f"NSI fit: DistributionMaker set-up and Asimov data"
          f" {time.perf_counter() - t0:.2f} s")
    truth = {n: dm.params[n]._rescaled_value
             for n in ("theta23", "eps_mutau_magn")}

    def fit():
        dm.reset_free()
        for name, value in truth.items():
            dm.params[name]._rescaled_value = min(0.95, value + 0.10)
        return Analysis().fit_recursively(data, dm, "mod_chi2", None,
                                          "device", {}, None)

    # one run, its objective's set-up and capture included (the fit's
    # evaluations dominate: ~20 ms each)
    t0 = time.perf_counter()
    waits, result = count_host_syncs(fit)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    meta = result.minimizer_metadata
    moved = {n: result.params[n]._rescaled_value - v for n, v in truth.items()}
    print(f"Analysis fit, NSI (16 free), device, float32: wall {wall:.3f} s"
          f" with the set-up and capture of its objective, nit"
          f" {meta['nit']}, nfev {meta['nfev']}, {waits} waits for the card"
          f" ({waits / meta['nfev']:.2f} per evaluation); off the truth by "
          + ", ".join(f"{n} {d:.3e}" for n, d in moved.items())
          + f" rescaled (bound {FIT_TOL:g}), metric {result.metric_val!r}"
          f" [{smi}]")
    check(all(abs(d) <= FIT_TOL for d in moved.values()),
          "the NSI fit did not recover theta23 and eps_mutau_magn")
    check(waits / meta["nfev"] <= DEVICE_FIT_WAITS,
          f"the NSI fit waited {waits / meta['nfev']:.2f} times per"
          " evaluation")
    add(launch_counts(chain))
    BasicAnalysis._compiled_cache.clear()
    del dm
    print(f"options path launches (primal, tangent, multitangent):"
          f" {tuple(total)} [{smi}]")
    check(total[0] > 0 and total[2] > 0, "a kernel of the options path never"
          " ran")
    return tuple(total)


def general_lane_kernels(chain):
    """The three kernels over GENERAL_LANES lanes of general packs, the
    shapes the NSI and LRI lanes give them (each lane its own theta,
    couplings from general_pack_cases in turn and sign; the flagship
    geometry), float64 and float32: the primal, the tangent along
    eps_mutau_magn, and the multitangent at K = 3 (eps_mutau_magn,
    eps_mutau_phase, v_lri) and K = 6 (also theta13, theta23, dm31). One
    launch over the lanes is held against the plain version in float64
    (primal KERNEL_ATOL, multitangent primal MULTI_PRIMAL_ATOL, tangents
    TANGENT_RTOL of each lane's and direction's largest; the float32 primal
    kernel at the 'large' couplings is printed, not held, as in
    general_pack_kernels), and each lane against its own single launch,
    which it must equal exactly. Then each launch's device-only time (a
    CUDA graph) beside as many single launches, with its bound. Returns
    per kernel and dtype the errors and, by K, the times."""
    import torch

    summary = {name: {} for name in KERNELS}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        geom, params = flagship_geometry(dtype)
        args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
        args64 = tuple(a.double() for a in args[:3]) + args[3:]
        tiles = geom["tiles"]
        cases = general_pack_cases(params)
        thetas = flagship_thetas(params, GENERAL_LANES)
        packs, dirs, large = [], [], []
        for b in range(GENERAL_LANES):
            label, _, eps, v_lri = cases[b % len(cases)]
            pack, d = general_pack(chain, thetas[b], eps, v_lri,
                                   1 if b % 2 == 0 else -1)
            packs.append(pack)
            dirs.append(d)
            large.append(label == "large")
        pvec = torch.stack(packs).to("cuda", dtype).contiguous()
        d6 = torch.stack(dirs).to("cuda", dtype).contiguous()  # (B, 6, 57)
        runs = {
            "osc_chain": [(0, None,
                           lambda p, d: (chain.chain_probs(p, *args, tiles),),
                           lambda p, d, a: (chain.chain_probs_reference(
                               p, *a),))],
            "osc_chain_tangent": [(1, d6[:, 3].contiguous(),
                                   lambda p, d: (chain.chain_tangent(
                                       p, d, *args, tiles),),
                                   lambda p, d, a: (
                                       chain.chain_tangent_reference(
                                           p, d, *a),))],
            "osc_chain_multitangent": [
                (k, dk, lambda p, d: chain.chain_multitangent(p, d, *args,
                                                              tiles),
                 lambda p, d, a: chain.chain_multitangent_reference(p, d, *a))
                for k, dk in ((3, d6[:, 3:].contiguous()), (6, d6))],
        }
        for name, variants in runs.items():
            summary[name][dname] = {"max_abs_err": 0.0, "times": {}}
            for k, d, run, plain in variants:
                t0 = time.perf_counter()
                got = run(pvec, d)
                ref = plain(pvec.double(), None if d is None else d.double(),
                            args64)
                torch.cuda.synchronize()
                check(all(bool(torch.isfinite(g).all()) for g in got),
                      f"general lanes, {name} K={k} {dname}: not finite")
                tangent = (k > 0,) if len(got) == 1 else (False, True)
                primal_err = torch.zeros(GENERAL_LANES, dtype=torch.float64)
                tangent_err = 0.0
                abs_err = 0.0
                for g, r, is_tangent in zip(got, ref, tangent):
                    diff = (g.double() - r).abs()
                    abs_err = max(abs_err, float(diff.max()))
                    if is_tangent:
                        scale = r.abs().amax(dim=(-3, -2, -1), keepdim=True)
                        tangent_err = max(tangent_err,
                                          float((diff / scale).max()))
                    else:
                        primal_err = diff.flatten(1).amax(1).cpu()
                del ref
                vs_single = 0.0
                for b in range(GENERAL_LANES):
                    single = run(pvec[b], None if d is None else d[b])
                    for g, one in zip(got, single):
                        vs_single = max(vs_single,
                                        float((g[b] - one).abs().max()))
                bound_abs = MULTI_PRIMAL_ATOL[dname] if k else KERNEL_ATOL[dname]
                # the float32 primal kernel at the large couplings: printed
                exempt = torch.tensor(large) & (dtype == torch.float32) & (k == 0)
                held = float(primal_err[~exempt].max())
                over = float(primal_err[exempt].max()) if exempt.any() else 0.0
                print(f"general lanes, {name} K={k} {dname}:"
                      f" {GENERAL_LANES} lanes of general packs in one launch"
                      f" vs plain (float64): primal {held:.3e} abs (bound"
                      f" {bound_abs:g})"
                      + (f", at the large couplings {over:.3e} (not held)"
                         if exempt.any() else "")
                      + f", tangents {tangent_err:.3e} rel (bound"
                      f" {TANGENT_RTOL[dname]:g}); vs {GENERAL_LANES} single"
                      f" launches {vs_single!r} (must be 0.0);"
                      f" {time.perf_counter() - t0:.1f} s")
                check(held <= bound_abs
                      and tangent_err <= TANGENT_RTOL[dname],
                      f"general lanes, {name} K={k} {dname}: off the plain"
                      " version")
                check(vs_single == 0.0,
                      f"general lanes, {name} K={k} {dname}: a lane differs"
                      f" from its single launch by {vs_single}")
                entry = summary[name][dname]
                entry["max_abs_err"] = max(entry["max_abs_err"], abs_err)
                entry["times"][k] = time_lanes(
                    f"general lanes, {name} K={k} {dname}, {GENERAL_LANES}"
                    " lanes", chain, geom, run, pvec, d, k, not tangent[0])
    return summary


def fisher_options_fp64(smi, pipelines):
    """float64, the 20x20-grid flagship (`pipelines`, {option: {device:
    Pipeline}}) under NSI (standard, eps_mutau_magn free) and under LRI
    (emu, v_lri free), 16 free params each: get_fisher_matrix on the card
    against the CPU, per entry within
    FISHER_OPTIONS_RTOL relative (and FISHER_OPTIONS_ZERO of sqrt(F_ii
    F_jj) for an entry that is round-off of a zero correlation); the
    card's launches must be one primal and ceil(16 / 6) multitangent
    launches per sign (the general packs' tangents)."""
    import numpy as np

    from pisa_tpu_torch.analysis.fisher import get_fisher_matrix
    from pisa_tpu_torch.ops.osc import chain

    for option in ("nsi", "lri-emu"):
        results = {}
        for device in ("cpu", "cuda"):
            ct = pipelines[option][device].compile()
            reset_launch_counts(chain)
            t0 = time.perf_counter()
            fm = get_fisher_matrix(ct)
            wall = time.perf_counter() - t0
            results[device] = (fm.matrix, wall, launch_counts(chain))
        (want, cpu_wall, _), (got, wall, launches) = (results["cpu"],
                                                      results["cuda"])
        n = want.shape[0]
        expected = (2, 0, 2 * -(-n // chain.MAX_TANGENTS))
        diag = np.sqrt(np.abs(np.diag(want)))
        scale = np.outer(diag, diag)
        mism = float((np.abs(got - want) / (FISHER_OPTIONS_RTOL
                                             * np.abs(want)
                                             + FISHER_OPTIONS_ZERO
                                             * scale)).max())
        nonzero = np.abs(want) > 1e-6 * scale
        rel = float((np.abs(got - want)[nonzero]
                     / np.abs(want)[nonzero]).max())
        print(f"float64 Fisher matrix, 20x20-grid flagship, {option} ({n}"
              f" params), card vs CPU: worst entry {rel:.3e} relative (of"
              f" the entries above 1e-6 of sqrt(F_ii F_jj)), worst at"
              f" {mism:.3e} of its bound (rtol {FISHER_OPTIONS_RTOL:g},"
              f" {FISHER_OPTIONS_ZERO:g} of sqrt(F_ii F_jj)); launches"
              f" {launches} (expected {expected}); wall {wall:.2f} s on the"
              f" card, {cpu_wall:.2f} s on the CPU [{smi}]")
        check(np.all(np.isfinite(got)), f"{option}: Fisher matrix not finite")
        check(mism <= 1.0, f"{option}: Fisher matrix, card vs CPU")
        check(launches == expected, f"{option}: Fisher launches {launches}")


def options_batch_fp64(smi, pipelines):
    """float64, batch_parity's fits and checks under prob3's options on the
    20x20-grid flagship (`pipelines`, {option: {device: Pipeline}}): NSI
    (standard, eps_mutau_magn free), decay (decay_alpha3 free) and
    calc_mode = events. Whether the lanes stop at different iterations is
    printed, not required."""
    for option in ("nsi", "decay", "events"):
        t0 = time.perf_counter()
        batch_parity(f"20x20-grid flagship, {option}", pipelines[option],
                     smi, require_spread=False)
        print(f"float64 batch parity, {option}: {time.perf_counter() - t0:.1f}"
              f" s [{smi}]")


def options_lanes_worker():
    """float64: fisher_options_fp64 and options_batch_fp64 in a child
    process, over one pipeline per option and device (the 20x20-grid
    flagship at OPTIONS_LANES_FP64_FRACTION of the events, the per-event
    mode at OPTIONS_BATCH_FRACTION: the CPU's plain tangents at all of them
    would take minutes)."""
    from pisa_tpu_torch import FTYPE_NAME
    from pisa_tpu_torch.core.pipeline import Pipeline

    check(FTYPE_NAME == "fp64", f"options lanes worker runs {FTYPE_NAME}")
    smi = card_line()
    t0 = time.perf_counter()
    pipelines = {
        option: {device: Pipeline(options_config(
            option, small=True, fraction=OPTIONS_BATCH_FRACTION
            if option == "events" else OPTIONS_LANES_FP64_FRACTION),
            device=device) for device in ("cuda", "cpu")}
        for option in ("nsi", "lri-emu", "decay", "events")}
    print(f"float64 options lanes set-up (8 pipelines):"
          f" {time.perf_counter() - t0:.1f} s [{smi}]")
    for label, phase in (("Fisher", fisher_options_fp64),
                         ("batch", options_batch_fp64)):
        t0 = time.perf_counter()
        phase(smi, pipelines)
        print(f"float64 options {label} phase: {time.perf_counter() - t0:.1f}"
              f" s [{smi}]")


def options_lanes_fp32(chain, smi):
    """Forward mode and lanes under NSI at full width, float32, through the
    entry points (this slice's main path): the NSI flagship
    (options_config('nsi'), 16 free) (1) get_fisher_matrix: its wall and
    launches (one primal and ceil(16 / 6) multitangent launches per sign);
    (2) fit_pseudo_ensemble(cd, 'mod_chi2', 16 trials, OPTIONS_ENSEMBLE_STEPS
    steps): wall per trial, evaluations, peak memory, the launches of one
    eager 16-lane value_and_grad and the captured one's wall, back-to-back
    and device time; then each further count of OPTIONS_TRIALS where its
    multiple of the first's peak fits in the card's free memory
    (torch.cuda.mem_get_info), else both numbers and the line 'N-lane NSI
    ensemble: does not fit'; (3)
    lane 0 beside its solo minimize_on_device fit (a report: the lane
    program and the solo one may round differently in float32); (4)
    mcmc_sampling with OPTIONS_MCMC's walkers: wall per step. The counts
    are set to 0 just before each path and read just after; returns their
    sums."""
    import numpy as np
    import torch

    from pisa_tpu_torch import TORCH_FTYPE
    from pisa_tpu_torch.analysis.bayesian import mcmc_sampling
    from pisa_tpu_torch.analysis.device_fit import (
        fit_pseudo_ensemble,
        minimize_on_device,
    )
    from pisa_tpu_torch.analysis.fisher import get_fisher_matrix
    from pisa_tpu_torch.analysis.gradient import CompiledDistribution
    from pisa_tpu_torch.core.distribution_maker import DistributionMaker
    from pisa_tpu_torch.core.pipeline import Pipeline

    total = [0, 0, 0]

    def add(launches):
        for i, n in enumerate(launches):
            total[i] += n

    # (1) the Fisher matrix
    ct = Pipeline(options_config("nsi"), device="cuda").compile()
    n = len(ct.free_names)
    get_fisher_matrix(ct)  # the first call builds the lazily cached tensors
    walls = []
    for _ in range(3):
        reset_launch_counts(chain)
        t0 = time.perf_counter()
        fm = get_fisher_matrix(ct)
        walls.append(time.perf_counter() - t0)
        launches = launch_counts(chain)
    expected = (2, 0, 2 * -(-n // chain.MAX_TANGENTS))
    print(f"float32 Fisher matrix, NSI flagship ({n} free), jacfwd of the"
          f" eager template: wall median {np.median(walls) * 1e3:.2f} ms of 3"
          f" (min {min(walls) * 1e3:.2f}); launches {launches} (expected"
          f" {expected}) [{smi}]")
    check(np.all(np.isfinite(fm.matrix)) and np.all(np.diag(fm.matrix) > 0),
          "NSI Fisher matrix not finite or not positive")
    check(launches == expected, f"NSI Fisher launches {launches}")
    add(launches)

    # (4) the sampler, on the same template
    data = ct.get_outputs(ct.current_rescaled_values())
    kwargs = dict(metric="llh", n_walkers=OPTIONS_MCMC["walkers"], seed=0,
                  init_spread=0.01)
    # a first call builds what the lanes' first evaluation caches
    mcmc_sampling(ct, data, n_burnin=0, n_steps=1, **kwargs)
    runs = {}
    for label, burn, steps in (("one step", 0, 1),
                               ("run", OPTIONS_MCMC["burnin"],
                                OPTIONS_MCMC["steps"])):
        if label == "run":
            reset_launch_counts(chain)
        t0 = time.perf_counter()
        waits, out = count_host_syncs(lambda: mcmc_sampling(
            ct, data, n_burnin=burn, n_steps=steps, **kwargs))
        runs[label] = (time.perf_counter() - t0, waits, out)
    launches = launch_counts(chain)
    (wall0, waits0, _), (wall, waits, (samples, logp, acceptance)) = (
        runs["one step"], runs["run"])
    steps = OPTIONS_MCMC["burnin"] + OPTIONS_MCMC["steps"] - 1
    per_step = (wall - wall0) / steps
    print(f"float32 MCMC, NSI flagship, {OPTIONS_MCMC['walkers']} walkers,"
          f" {OPTIONS_MCMC['burnin']} burn-in + {OPTIONS_MCMC['steps']}"
          f" steps: {per_step * 1e3:.2f} ms per step (the standard route's:"
          f" mcmc_fp32), acceptance {acceptance:.3f},"
          f" {(waits - waits0) / steps:g} host waits per step; launches"
          f" {launches} [{smi}]")
    check(np.all(np.isfinite(samples)) and np.all(np.isfinite(logp)),
          "NSI MCMC chain not finite")
    check((waits - waits0) == 0, "the NSI sampler waited within its steps")
    check(launches[0] > 0, "the primal kernel never ran for the walkers")
    add(launches)
    del ct, data, runs

    # (2) the pseudo-ensembles
    dm = DistributionMaker([options_config("nsi")], device="cuda")
    cd = CompiledDistribution(dm)
    x_nom = cd.current_rescaled_values()
    asimov = cd.sum_hist(x_nom)
    los, his = cd._device_bounds()
    eager = cd._objective(asimov, "mod_chi2")
    lam = torch.as_tensor(asimov, dtype=TORCH_FTYPE, device="cuda")
    data = torch.poisson(lam.expand(OPTIONS_TRIALS[0], -1).contiguous())
    reset_launch_counts(chain)
    vec = torch.as_tensor(np.tile(x_nom, (OPTIONS_TRIALS[0], 1)),
                          device="cuda").requires_grad_(True)
    eager(vec, los, his, data).sum().backward()
    torch.cuda.synchronize()
    vg_launches = launch_counts(chain)
    print(f"float32 NSI batched value_and_grad, {OPTIONS_TRIALS[0]} lanes,"
          f" eager: launches {vg_launches} (expected (2, 0, 0)) [{smi}]")
    check(vg_launches == (2, 0, 0), f"NSI lanes' launches {vg_launches}")
    del vec, data
    peak = {}
    ens = None
    for trials in OPTIONS_TRIALS:
        if trials != OPTIONS_TRIALS[0]:
            torch.cuda.empty_cache()
            free, _ = torch.cuda.mem_get_info()
            need = trials // OPTIONS_TRIALS[0] * peak[OPTIONS_TRIALS[0]]
            print(f"{trials}-lane NSI ensemble: {need / 2**30:.2f} GiB"
                  f" predicted ({trials // OPTIONS_TRIALS[0]}x the"
                  f" {OPTIONS_TRIALS[0]}-lane peak), {free / 2**30:.2f} GiB"
                  f" free on the card [{smi}]")
            if need > free:
                print(f"{trials}-lane NSI ensemble: does not fit")
                continue
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launch_counts(chain)
        t0 = time.perf_counter()
        out = fit_pseudo_ensemble(cd, "mod_chi2", n_trials=trials, seed=0,
                                  max_steps=OPTIONS_ENSEMBLE_STEPS)
        wall = time.perf_counter() - t0
        launches = launch_counts(chain)
        peak[trials] = torch.cuda.max_memory_allocated() - base
        nit = out["nit"]
        print(f"fit_pseudo_ensemble, NSI flagship, {trials} trials,"
              f" mod_chi2, {OPTIONS_ENSEMBLE_STEPS} steps, float32: wall"
              f" {wall:.3f} s with its capture ({wall / trials * 1e3:.2f} ms"
              f" a trial), nit median {float(np.median(nit))} max"
              f" {int(nit.max())}, {out['nfev']} evaluations, {out['reads']}"
              f" flag reads; peak memory above what was resident"
              f" {peak[trials] / 2**20:.1f} MiB"
              f" ({peak[trials] / trials / 2**20:.1f} MiB a lane); launches"
              f" {launches} [{smi}]")
        check(np.all(np.isfinite(out["fun"])) and np.all(nit > 0),
              f"the {trials}-trial NSI ensemble's fits are not all finite")
        check(launches[0] > 0, "the NSI ensemble launched no primal kernel")
        add(launches)
        if ens is None:
            ens = out
            # the captured lanes' value_and_grad the ensemble ran, at its
            # best fits: wall (with the read), back to back, device time
            value_fn, _ = cd.build_objective(asimov, "mod_chi2")
            program = value_fn.raw_with_data.programs[(trials, True)]
            program.load_extra(torch.as_tensor(out["data"], device="cuda",
                                               dtype=TORCH_FTYPE))
            vec = torch.as_tensor(out["x"], device="cuda")

            def vg():
                value, grad = program.value_and_grad(vec, los, his)
                return torch.cat([value.reshape(-1), grad.reshape(-1)]).cpu()

            vg_wall, vg_min = median_wall(vg, 5)
            back_ms = cuda_time(lambda: program.value_and_grad(vec, los, his),
                                5)
            _, device_ms, _, _, kernels = profile_device_busy(
                lambda: program.value_and_grad(vec, los, his))
            print(f"float32 NSI captured value_and_grad, {trials} lanes:"
                  f" wall {vg_wall * 1e3:.2f} ms median of 5 (min"
                  f" {vg_min * 1e3:.2f}), {back_ms:.2f} ms back to back"
                  f" ({back_ms / trials:.2f} ms a lane); one replay:"
                  f" {kernels} kernels, {device_ms:.2f} ms of device time"
                  f" [{smi}]")

    # (3) lane 0 beside its solo fit
    value_0, _ = cd.build_objective(ens["data"][0], "mod_chi2")
    bounds = cd._current_bounds()
    reset_launch_counts(chain)
    t0 = time.perf_counter()
    solo = minimize_on_device(value_0.raw, x_nom, *bounds,
                              max_steps=OPTIONS_ENSEMBLE_STEPS, device="cuda")
    solo_wall = time.perf_counter() - t0
    add(launch_counts(chain))
    print(f"solo minimize_on_device, NSI, trial 0's data, same start,"
          f" float32: wall {solo_wall:.3f} s with its capture, nit"
          f" {solo['nit']} (lane 0: {int(ens['nit'][0])}), {solo['nfev']}"
          f" evaluations; max |x - lane 0's| "
          f"{float(np.abs(solo['x'] - ens['x'][0]).max()):.3e} rescaled"
          f" [{smi}]")
    del dm, cd
    print(f"options lanes path launches (primal, tangent, multitangent):"
          f" {tuple(total)} [{smi}]")
    return tuple(total)


def osc_lanes_only_main(chain, smi):
    """``--osc-lanes-only``: the kernels built, then this slice's phases
    alone (general_lane_kernels, the float64 child's Fisher and batch
    parity, then options_lanes_fp32); no status line."""
    t0 = time.perf_counter()
    general_lane_kernels(chain)
    print(f"general lanes kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--osc-lanes-worker"],
                   env=dict(os.environ, PISA_TPU_FTYPE="fp64"), check=True)
    print(f"float64 child (options lanes): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = options_lanes_fp32(chain, smi)
    print(f"float32 options lanes phase: {time.perf_counter() - t0:.1f} s;"
          f" launches {launches}")
    return 0


def osc_options_only_main(chain, smi):
    """``--osc-options-only``: the kernels built, held at general packs,
    then the options phases alone (the float64 child's and the main
    process's); no status line."""
    general_pack_kernels(chain)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--osc-options-worker"],
                   env=dict(os.environ, PISA_TPU_FTYPE="fp64"), check=True)
    print(f"float64 child (options): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = osc_options_fp32(chain, smi)
    print(f"float32 options phase: {time.perf_counter() - t0:.1f} s;"
          f" launches {launches}")
    return 0


# -- 3+1 sterile oscillations (nusquids, globes) and the herm4_eig kernel ------
def sterile_config(tmp, grid_bins=None, fraction=None, num_neutrinos=4,
                   lowpass=True):
    """The flagship with osc.nusquids (testing/sterile_flagship.py): the 3+1
    search (17 free) or, with `num_neutrinos` = 3, the 3-flavour route;
    `lowpass` False sets prop_lowpass_cutoff = 0 (the amplitude picture)."""
    from pisa_tpu_torch.testing.sterile_flagship import (
        sterile_flagship_config,
    )

    config = sterile_flagship_config(tmp, grid_bins, fraction,
                                     num_neutrinos=num_neutrinos)
    if not lowpass:
        config[("osc", "nusquids")]["prop_lowpass_cutoff"] = 0.0
    return config


def sterile_steps(dtype):
    """The 3+1 engine's prepared layer steps on the 3+1 flagship's 200x200
    grid and Earth model, on the card, and its oscillation params."""
    from pisa_tpu_torch.ops.osc.layers import Layers
    from pisa_tpu_torch.ops.osc.sterile import prepare_4nu_geometry
    from pisa_tpu_torch.stages.osc.nusquids import grid_points

    with tempfile.TemporaryDirectory() as tmp:
        config = sterile_config(tmp)
    settings = config[("osc", "nusquids")]
    selector = settings["params"]
    selector.select_params(config["pipeline"]["param_selections"])
    params = {p.name: p for p in selector.params}
    layers = Layers(params["earth_model"].value,
                    params["detector_depth"].m_as("km"),
                    params["prop_height"].m_as("km"))
    layers.setElecFrac(*(params[n].m_as("dimensionless")
                         for n in ("YeI", "YeO", "YeM")))
    energy, coszen = grid_points(settings["calc_mode"])
    layers.calcLayers(coszen)
    shape = (energy.size, layers.max_layers)
    return prepare_4nu_geometry(
        energy, layers.density.reshape(shape),
        layers.density_neutron_weighted.reshape(shape),
        layers.distance.reshape(shape), dtype=dtype, device="cuda"), params


def sterile_points(params, count=4):
    """(the 9 mixing angles, the 4 splittings) at the 3+1 flagship's nominal
    and at `count` - 1 seeded points."""
    import numpy as np

    angles = [params[n].m_as("rad") for n in STERILE_ANGLES]
    dms = [0.0] + [params[n].m_as("eV**2")
                   for n in ("deltam21", "deltam31", "deltam41")]
    rng = np.random.RandomState(20261017)
    points = [(angles, dms)]
    for _ in range(count - 1):
        a = list(angles)
        a[2] = np.radians(rng.uniform(38, 52))   # theta23
        a[3] = np.radians(rng.uniform(0, 10))    # theta14
        a[4] = np.radians(rng.uniform(0, 30))    # theta24
        a[5] = np.radians(rng.uniform(0, 30))    # theta34
        points.append((a, [0.0, dms[1], dms[2], rng.uniform(0.3, 3.0)]))
    return points


def herm4_plain(herm4, H):
    """The plain version on the card, in chunks that cuSOLVER takes."""
    import torch

    parts = [herm4.herm4_eig_reference(x) for x in H.split(HERM4_CHUNK)]
    return torch.cat([w for w, _ in parts]), torch.cat([v for _, v in parts])


def herm4_library_ms(H):
    """One torch.linalg.eigvalsh call on the whole batch, device time of
    one of 2 after a warm-up: with the default backend where it takes the
    batch, else with MAGMA's. Returns (ms, backend)."""
    import torch

    backend = "default"
    try:
        torch.linalg.eigvalsh(H)
        torch.cuda.synchronize()
    except RuntimeError as exc:
        print(f"torch.linalg.eigvalsh on {H.shape[0]} matrices, default"
              f" backend: {str(exc).splitlines()[0][:100]}")
        backend = "magma"
    torch.backends.cuda.preferred_linalg_library(backend)
    try:
        torch.linalg.eigvalsh(H)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(2):
            torch.linalg.eigvalsh(H)
        stop.record()
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.preferred_linalg_library("default")
    return start.elapsed_time(stop) / 2, backend


def herm4_derivatives(herm4, H, smi):
    """float64: the Function's jvp and backward against central differences
    of the kernel, on the first HERM4_FD['matrices'] matrices of H, along a
    random Hermitian direction scaled per matrix to its smallest eigenvalue
    gap (the active cluster's gaps are ~1e-4 of |H|: a step scaled to |H|
    would cross them), with a step of HERM4_FD['step'] of it; errors
    relative to the gap. Matrices whose smallest gap is below
    HERM4_FD['min_gap'] of |H| (the mu/tau pair at the highest energies)
    are left out: there the differences' rounding exceeds the bound."""
    import numpy as np
    import torch

    H = H[:HERM4_FD["matrices"]]
    norm = torch.linalg.matrix_norm(H)
    gap = torch.diff(herm4.herm4_eig(H)[0], dim=-1).amin(-1)
    keep = gap > HERM4_FD["min_gap"] * norm
    H, gap = H[keep], gap[keep]
    rng = np.random.RandomState(7)
    a = rng.normal(size=(H.shape[0], 4, 4)) + 1j * rng.normal(
        size=(H.shape[0], 4, 4))
    dH = torch.as_tensor(0.5 * (a + np.conj(np.swapaxes(a, -1, -2))),
                         device="cuda")
    dH = dH * (gap / torch.linalg.matrix_norm(dH))[:, None, None]
    h = HERM4_FD["step"]
    fd = (herm4.herm4_eig(H + h * dH)[0] - herm4.herm4_eig(H - h * dH)[0]) / (
        2 * h)
    _, jvp = torch.func.jvp(herm4.eigvalsh4, (H,), (dH,))
    g = torch.as_tensor(rng.normal(size=(H.shape[0], 4)), device="cuda")
    Hr = H.clone().requires_grad_(True)
    gH = torch.autograd.grad((herm4.eigvalsh4(Hr) * g).sum(), Hr)[0]
    back = (gH.real * dH.real + gH.imag * dH.imag).sum((-2, -1))
    err_jvp = float(((jvp - fd).abs() / gap[:, None]).max())
    err_back = float(((back - (g * fd).sum(-1)).abs()
                      / (gap * g.abs().sum(-1))).max())
    print(f"herm4_eig float64 derivatives, {H.shape[0]} of"
          f" {HERM4_FD['matrices']} matrices (the rest have a gap below"
          f" {HERM4_FD['min_gap']:g} of |H|): jvp vs central differences"
          f" {err_jvp:.3e}, backward vs them {err_back:.3e} of the smallest"
          f" gap (a step of {h:g} of it, bound {HERM4_FD['tol']:g}) [{smi}]")
    check(H.shape[0] > HERM4_FD["matrices"] // 2,
          "herm4_eig derivatives: too few matrices with a resolvable gap")
    check(err_jvp <= HERM4_FD["tol"] and err_back <= HERM4_FD["tol"],
          "herm4_eig's derivatives are off the finite differences")


def herm4_vs_plain(smi):
    """herm4_eig against its plain version (torch.linalg.eigh, on the card
    in chunks of HERM4_CHUNK) and against torch.linalg.eigvalsh (the same
    chunks) at the 3+1 flagship's layer steps (nu and
    nubar, nominal and 3 seeded points), float64 and float32; the float64
    derivatives; the kernel's device-only time (a CUDA graph of 20
    launches), the plain version's, one torch.linalg.eigvalsh call's (the
    library time), the bound and the registers. Returns {dtype: line}."""
    import torch

    from pisa_tpu_torch.ops.osc import herm4, sterile

    geom, params = sterile_steps(torch.float64)
    points = sterile_points(params)
    n = geom["e"].shape[0]
    out = {}
    for dname, cdt in (("float64", torch.complex128),
                       ("float32", torch.complex64)):
        worst_abs = worst_rel = 0.0
        nominal = None
        for nubar in (1, -1):
            for i, (angles, dms) in enumerate(points):
                U = sterile.pmns4_matrix(*angles, device="cuda")
                if nubar < 0:
                    U = torch.complex(U.real, -U.imag)
                H = sterile.layer_hamiltonians(
                    U, torch.tensor(dms, dtype=torch.float64, device="cuda"),
                    nubar, geom["e"], geom["rho_e"], geom["rho_n"]).to(cdt)
                w, _, sweeps = herm4.herm4_eig(H, sweeps=True)
                norm = torch.linalg.matrix_norm(H.to(torch.complex128))
                # the plain version's eigenvalues, and eigvalsh's
                for want in (herm4_plain(herm4, H)[0], torch.cat([
                        torch.linalg.eigvalsh(x)
                        for x in H.split(HERM4_CHUNK)])):
                    err = (w.double() - want.double()).abs()
                    worst_abs = max(worst_abs, float(err.max()))
                    worst_rel = max(worst_rel,
                                    float((err / norm[:, None]).max()))
                if nubar > 0 and i == 0:
                    nominal = (H, sweeps)
        H, sweeps = nominal
        check(worst_rel <= HERM4_TOL[dname],
              f"herm4_eig {dname}: {worst_rel:.3e} of |H| off the plain"
              " version")
        if dname == "float64":
            herm4_derivatives(herm4, H, smi)
        ms = graph_time(lambda: herm4.herm4_eig(H), launches=20, replays=5)
        plain_ms = cuda_time(lambda: herm4_plain(herm4, H), 3)
        library_ms, backend = herm4_library_ms(H)
        chunked_ms = cuda_time(lambda: [torch.linalg.eigvalsh(x)
                                        for x in H.split(HERM4_CHUNK)], 3)
        size = torch.finfo(torch.float64 if dname == "float64"
                           else torch.float32).bits // 8
        nbytes = n * (32 + 4 + 32) * size
        ops = herm4.herm4_operations(sweeps.cpu())
        t_ops = ops / PEAK_FLOPS[dname] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        attrs = herm4.kernel_attributes(cdt)
        out[dname] = dict(
            max_abs_err=worst_abs, max_rel_err=worst_rel, ms=ms,
            plain_ms=plain_ms, library_ms=library_ms,
            library_backend=backend, bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            sweeps_mean=float(sweeps.float().mean()), **attrs)
        print(f"herm4_eig {dname}, {n} matrices (the 3+1 flagship's layer"
              f" steps of one sign), 8 batches (2 signs x 4 points): max"
              f" |w - plain| (torch.linalg.eigh and eigvalsh)"
              f" {worst_abs:.3e}, {worst_rel:.3e} of |H| (bound"
              f" {HERM4_TOL[dname]:g}); device-only {ms:.4f} ms, plain"
              f" (torch.linalg.eigh in chunks of {HERM4_CHUNK}) {plain_ms:.3f}"
              f" ms, torch.linalg.eigvalsh in one call ({backend} backend)"
              f" {library_ms:.3f} ms, in chunks of {HERM4_CHUNK}"
              f" {chunked_ms:.3f} ms; bound {max(t_ops, t_bytes):.4f} ms by"
              f" {out[dname]['bound_by']} ({ops} operations over"
              f" {out[dname]['sweeps_mean']:.2f} sweeps a matrix, {nbytes}"
              f" bytes; {100 * max(t_ops, t_bytes) / ms:.1f}% of bound);"
              f" {attrs['registers']} registers, {attrs['local_bytes']} local"
              f" bytes, {attrs['blocks_per_sm']} blocks of"
              f" {attrs['threads']} per SM [{smi}]")
    return out


def maps_mismatch(got, want):
    """Worst |got - want| per bin over each map's largest |want|."""
    import numpy as np

    worst = 0.0
    for m in want:
        ref = np.asarray(m.hist)
        worst = max(worst, float(np.abs(np.asarray(got[m.name].hist) - ref)
                                 .max() / np.abs(ref).max()))
    return worst


def pipeline_card_vs_cpu(label, make_config, smi):
    """float64: the pipeline of make_config() on the card against the CPU:
    the eager maps (each bin within TEMPLATE_RTOL of its map's largest),
    and the compiled mod_chi2 value_and_grad (the card's captured) at
    gradient_point with the CPU's maps as data, within VG_FP64."""
    import numpy as np

    from pisa_tpu_torch.core.pipeline import Pipeline

    from pisa_tpu_torch.ops.osc import herm4
    results = {}
    data = None
    for device in ("cpu", "cuda"):
        herm4.launch_count = 0
        t0 = time.perf_counter()
        pipeline = Pipeline(make_config(), device=device)
        maps = pipeline.get_outputs()
        if data is None:
            data = {m.name: np.asarray(m.hist) for m in maps}
        ct = pipeline.compile()
        _, vg = ct.build_objective(data, "mod_chi2")
        value, grad = vg(gradient_point(ct))
        results[device] = (maps, float(value), grad.cpu().numpy(),
                           time.perf_counter() - t0, herm4.launch_count,
                           ct.stacked)
    (cpu_maps, want, want_g, cpu_s, _, _), (maps, got, got_g, card_s,
                                            launches, stacked) = (
        results["cpu"], results["cuda"])
    worst = maps_mismatch(maps, cpu_maps)
    rel = abs(got - want) / abs(want)
    mism = grad_mismatch(got_g, want_g, VG_FP64["grad_rtol"],
                         VG_FP64["grad_atol"])
    print(f"float64 {label} ({'stacked' if stacked else 'per container'},"
          f" {len(got_g)} free), card vs CPU: maps {worst:.3e} of each map's"
          f" largest bin (bound {TEMPLATE_RTOL['float64']:g}); captured"
          f" value {got!r} vs {want!r} ({rel:.3e} relative, bound"
          f" {VG_FP64['value']:g}); gradient {rel_max(got_g, want_g):.3e} of"
          f" max|g|, worst entry at {mism:.3e} of its bound; herm4_eig"
          f" launches {launches}; set-up, template and value_and_grad"
          f" {card_s:.1f} s on the card, {cpu_s:.1f} s on the CPU [{smi}]")
    check(np.isfinite(got) and np.all(np.isfinite(got_g)),
          f"{label}: not finite on the card")
    check(worst <= TEMPLATE_RTOL["float64"], f"{label}: card maps vs CPU")
    check(rel <= VG_FP64["value"], f"{label}: card value vs CPU")
    check(mism <= 1.0, f"{label}: card gradient vs CPU")


def sterile_fp64(smi):
    """float64, card against CPU: sterile_example.cfg; the 20x20-grid 3+1
    flagship in the low-pass picture and in the amplitude picture; then, on
    the card, the 3-flavour nusquids flagship against the prob3 flagship on
    the 20x20 grid (the same physics: NUSQUIDS3_TOL of each map's largest
    bin)."""
    from pisa_tpu_torch.core.pipeline import Pipeline
    from pisa_tpu_torch.ops.osc import chain

    with tempfile.TemporaryDirectory() as tmp:
        for label, make in (
                ("sterile_example.cfg", lambda: STERILE_CFG),
                ("3+1 flagship, 20x20 grid, low-pass",
                 lambda: sterile_config(tmp, 20)),
                ("3+1 flagship, 20x20 grid, amplitude picture",
                 lambda: sterile_config(tmp, 20, lowpass=False))):
            t0 = time.perf_counter()
            pipeline_card_vs_cpu(label, make, smi)
            print(f"float64 {label}: {time.perf_counter() - t0:.1f} s")
        reset_launch_counts(chain)
        got = Pipeline(sterile_config(tmp, 20, num_neutrinos=3),
                       device="cuda").get_outputs()
        launches = launch_counts(chain)
        want = Pipeline(small_grid_config(), device="cuda").get_outputs()
    worst = maps_mismatch(got, want)
    print(f"float64 nusquids (3 flavours, the general-pack route) vs prob3"
          f" (the standard route), 20x20-grid flagship on the card: maps"
          f" {worst:.3e} of each map's largest bin (bound"
          f" {NUSQUIDS3_TOL:g}); nusquids launches {launches} [{smi}]")
    check(worst <= NUSQUIDS3_TOL, "nusquids (3 flavours) vs prob3")
    check(launches == (2, 0, 0), f"nusquids (3 flavours) launches {launches}")


def sterile_worker():
    """float64: sterile_fp64 in a child process."""
    from pisa_tpu_torch import FTYPE_NAME

    check(FTYPE_NAME == "fp64", f"sterile worker runs {FTYPE_NAME}")
    smi = card_line()
    t0 = time.perf_counter()
    sterile_fp64(smi)
    print(f"float64 sterile phase: {time.perf_counter() - t0:.1f} s [{smi}]")


def sterile_resonance_fp32(smi):
    """The 3+1 engine in float32 on the card, with herm4_eig for the
    eigenvalues, at the resonance set of tests/test_sterile.py:304-341
    (PREM-12 chains at coszen -1..-0.3, 100, 500 and 2000 GeV, both signs):
    every row sum within STERILE_ROW_SUM of 1, the JAX package's own
    bound."""
    import numpy as np
    import torch

    from pisa_tpu_torch.ops.osc import sterile
    from pisa_tpu_torch.ops.osc.layers import Layers

    layers = Layers("osc/PREM_12layer.dat", 2.0, 20.0)
    layers.setElecFrac(0.4656, 0.4656, 0.4957)
    cz = np.linspace(-1.0, -0.3, 8)
    layers.calcLayers(cz)
    n = int(np.max(layers.n_layers))
    dens = layers.density.reshape(len(cz), -1)[:, :n]
    dist = layers.distance.reshape(len(cz), -1)[:, :n]
    U = sterile.pmns4_matrix(0.5839, 0.1496, 0.7854, 0.12, 0.15, 0.0, 1.2,
                             0.0, 0.0, device="cuda")
    dms = torch.tensor([0.0, 7.42e-5, 2.514e-3, 1.0], dtype=torch.float64,
                       device="cuda")
    worst = 0.0
    for energy in (100.0, 500.0, 2000.0):
        for nubar in (1, -1):
            e = torch.full((len(cz),), energy, dtype=torch.float32,
                           device="cuda")
            p = sterile.osc_probs_layers_4nu(dms, U, nubar, e, dens,
                                             dens * 0.468, dist).cpu().numpy()
            worst = max(worst, float(np.abs(p.sum(axis=2) - 1.0).max()),
                        float(-p.min()))
    print(f"float32 3+1 engine on the card at the TeV resonance set: worst"
          f" |row sum - 1| {worst:.3e} (bound {STERILE_ROW_SUM:g}) [{smi}]")
    check(worst <= STERILE_ROW_SUM,
          "the float32 3+1 engine's rows do not sum to 1 at the resonance")


def sterile_fp32(chain, smi):
    """The 3+1 flagship at full width, float32, through the entry points
    (this slice's main path): the eager template; the captured
    value_and_grad (measure_vg: wall, kernels, busy share, peak memory; no
    wait inside the replay); Analysis().fit_recursively(..., 'device',
    {'max_steps': STERILE_FIT_STEPS}, ...) from theta24 moved by
    STERILE_MOVE rescaled; get_fisher_matrix on its
    17 free params; fit_pseudo_ensemble with STERILE_TRIALS lanes (fewer
    only where the lanes' peak memory measured at B = 1 says they cannot
    fit); then the 3-flavour nusquids flagship (the chain kernels): its
    template, captured value_and_grad and Fisher matrix. The counts are set
    to 0 just before each path and read just after; returns the sums of
    the chain kernels' and of herm4_eig's."""
    import numpy as np
    import torch

    from pisa_tpu_torch import TORCH_FTYPE, ureg
    from pisa_tpu_torch.analysis.analysis import Analysis, BasicAnalysis
    from pisa_tpu_torch.analysis.device_fit import fit_pseudo_ensemble
    from pisa_tpu_torch.analysis.fisher import get_fisher_matrix
    from pisa_tpu_torch.analysis.gradient import CompiledDistribution
    from pisa_tpu_torch.core.distribution_maker import DistributionMaker
    from pisa_tpu_torch.core.pipeline import Pipeline
    from pisa_tpu_torch.testing.sterile_flagship import write_sterile_flagship

    from pisa_tpu_torch.ops.osc import herm4
    total, total_h4 = [0, 0, 0], 0

    def reset():
        reset_launch_counts(chain)
        herm4.launch_count = 0

    def add():
        nonlocal total_h4
        for i, n in enumerate(launch_counts(chain)):
            total[i] += n
        total_h4 += herm4.launch_count
        return launch_counts(chain), herm4.launch_count

    with tempfile.TemporaryDirectory() as tmp:
        cfg = write_sterile_flagship(tmp)
        # the eager template
        reset()
        t0 = time.perf_counter()
        pipeline = Pipeline(cfg, device="cuda")
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        maps = pipeline.get_outputs()
        totals = [float(m.hist.sum()) for m in maps]
        first_s = time.perf_counter() - t0
        check(all(np.isfinite(t) and t > 0 for t in totals),
              "3+1 flagship: template not finite")
        walls = []
        for i in range(5):
            pipeline.params["theta24"].value = (8.0 + 0.1 * (i + 1)) * ureg.degree
            t0 = time.perf_counter()
            pipeline.get_outputs()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches, h4 = add()
        print(f"float32 3+1 flagship: Pipeline set-up {setup_s:.2f} s, first"
              f" template {first_s:.2f} s, then get_outputs median"
              f" {np.median(walls) * 1e3:.2f} ms (5 runs), {sum(totals):.1f}"
              f" expected events; herm4_eig launches {h4} (2 a template),"
              f" chain launches {launches} [{smi}]")
        check(h4 == 12, f"3+1 flagship templates: {h4} herm4_eig launches")
        pipeline.params["theta24"].value = 8.0 * ureg.degree

        # the captured value_and_grad
        ct = pipeline.compile()
        check(not ct.stacked and len(ct.free_names) == STERILE_FREE,
              f"3+1 flagship template: stacked {ct.stacked},"
              f" {len(ct.free_names)} free")
        reset()
        measure_vg("3+1 flagship", ct, chain, smi)
        launches, h4 = add()
        print(f"3+1 flagship value_and_grad path: herm4_eig launches {h4}"
              f" [{smi}]")
        check(h4 > 0, "the 3+1 value_and_grad launched no herm4_eig")

        # the Fisher matrix of its 17 free params
        get_fisher_matrix(ct)  # the first call builds the cached tensors
        reset()
        t0 = time.perf_counter()
        fm = get_fisher_matrix(ct)
        wall = time.perf_counter() - t0
        launches, h4 = add()
        print(f"float32 Fisher matrix, 3+1 flagship ({len(fm.parameters)}"
              f" params), jacfwd of the eager template: wall"
              f" {wall * 1e3:.2f} ms; herm4_eig launches {h4} (one a sign:"
              f" the jvp rule is torch ops); sigma(theta24)"
              f" {fm.get_sigma('theta24')!r} [{smi}]")
        check(np.all(np.isfinite(fm.matrix)) and np.all(np.diag(fm.matrix)
                                                        > 0),
              "3+1 Fisher matrix not finite or not positive")
        check(h4 == 2, f"3+1 Fisher: {h4} herm4_eig launches")
        del ct, pipeline, maps

        # the device fit through the analysis layer
        reset()
        dm = DistributionMaker([cfg], device="cuda")
        data = dm.get_outputs(return_sum=True)
        truth = dm.params["theta24"]._rescaled_value

        def fit():
            dm.reset_free()
            dm.params["theta24"]._rescaled_value = min(0.95,
                                                       truth + STERILE_MOVE)
            return Analysis().fit_recursively(
                data, dm, "mod_chi2", None, "device",
                {"max_steps": STERILE_FIT_STEPS}, None)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        waits, result = count_host_syncs(fit)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        meta = result.minimizer_metadata
        moved = result.params["theta24"]._rescaled_value - truth
        launches, h4 = add()
        print(f"Analysis fit, 3+1 flagship ({STERILE_FREE} free), device"
              f" (max_steps {STERILE_FIT_STEPS}), float32: wall {wall:.3f} s"
              f" with the set-up and capture of"
              f" its objective, nit {meta['nit']}, nfev {meta['nfev']},"
              f" {waits} waits for the card ({waits / meta['nfev']:.2f} per"
              f" evaluation), theta24 off the truth by {moved:.3e} rescaled"
              f" (bound {FIT_TOL:g}), metric {result.metric_val!r}; peak"
              f" memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB;"
              f" herm4_eig launches {h4} [{smi}]")
        check(abs(moved) <= FIT_TOL, "the 3+1 fit did not recover theta24")
        check(waits / meta["nfev"] <= DEVICE_FIT_WAITS,
              f"the 3+1 fit waited {waits / meta['nfev']:.2f} times per"
              " evaluation")
        BasicAnalysis._compiled_cache.clear()

        # the pseudo-ensemble
        cd = CompiledDistribution(dm)
        x_nom = cd.current_rescaled_values()
        asimov = cd.sum_hist(x_nom)
        los, his = cd._device_bounds()
        lam = torch.as_tensor(asimov, dtype=TORCH_FTYPE, device="cuda")
        eager = cd._objective(asimov, "mod_chi2")
        reset()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        vec = torch.as_tensor(x_nom[None], device="cuda").requires_grad_(True)
        eager(vec, los, his, torch.poisson(lam[None])).sum().backward()
        torch.cuda.synchronize()
        per_lane = torch.cuda.max_memory_allocated() - base
        add()
        del vec
        torch.cuda.empty_cache()
        free, _ = torch.cuda.mem_get_info()
        trials = STERILE_TRIALS
        if trials * per_lane > free:
            trials = max(1, int(free // per_lane))
        print(f"3+1 ensemble: one lane's eager value_and_grad peaks at"
              f" {per_lane / 2**20:.1f} MiB; {STERILE_TRIALS} lanes need"
              f" {STERILE_TRIALS * per_lane / 2**30:.2f} GiB, the card has"
              f" {free / 2**30:.2f} GiB free: {trials} trials [{smi}]")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset()
        t0 = time.perf_counter()
        out = fit_pseudo_ensemble(cd, "mod_chi2", n_trials=trials, seed=0,
                                  max_steps=STERILE_ENSEMBLE_STEPS)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        launches, h4 = add()
        nit = out["nit"]
        print(f"fit_pseudo_ensemble, 3+1 flagship, {trials} trials,"
              f" mod_chi2, {STERILE_ENSEMBLE_STEPS} steps, float32: wall"
              f" {wall:.3f} s with its capture ({wall / trials * 1e3:.2f} ms"
              f" a trial), nit median {float(np.median(nit))} max"
              f" {int(nit.max())}, {out['nfev']} evaluations, {out['reads']}"
              f" flag reads; peak memory above what was resident"
              f" {peak / 2**20:.1f} MiB ({peak / trials / 2**20:.1f} MiB a"
              f" lane); herm4_eig launches {h4} [{smi}]")
        check(np.all(np.isfinite(out["fun"])) and np.all(nit > 0),
              "the 3+1 ensemble's fits are not all finite")
        del cd, dm, eager

        # the 3-flavour nusquids flagship: the chain kernels
        reset()
        pipeline = Pipeline(sterile_config(tmp, num_neutrinos=3),
                            device="cuda")
        maps = pipeline.get_outputs()
        check(all(np.isfinite(float(m.hist.sum())) for m in maps),
              "3-flavour nusquids flagship: template not finite")
        launches, _ = add()
        check(launches == (2, 0, 0),
              f"3-flavour nusquids template launches {launches}")
        ct = pipeline.compile()
        reset()
        vg_launches = measure_vg("3-flavour nusquids flagship", ct, chain,
                                 smi)
        check(vg_launches == (2, 0, 0),
              f"3-flavour nusquids value_and_grad launches {vg_launches}")
        add()
        get_fisher_matrix(ct)
        reset()
        t0 = time.perf_counter()
        get_fisher_matrix(ct)
        wall = time.perf_counter() - t0
        launches, _ = add()
        n = len(ct.free_names)
        expected = (2, 0, 2 * -(-n // chain.MAX_TANGENTS))
        print(f"float32 Fisher matrix, 3-flavour nusquids flagship ({n}"
              f" free): wall {wall * 1e3:.2f} ms; launches {launches}"
              f" (expected {expected}) [{smi}]")
        check(launches == expected,
              f"3-flavour nusquids Fisher launches {launches}")
        del ct, pipeline, maps
    print(f"sterile path launches (primal, tangent, multitangent):"
          f" {tuple(total)}, herm4_eig {total_h4} [{smi}]")
    check(total_h4 > 0, "herm4_eig never ran on the sterile path")
    return tuple(total), total_h4


def xsec_service(name, device, n_events):
    """The xsec service `name` from its init_test at MCEQ_XSEC's values,
    on the service matrix's two containers with `n_events` synthetic
    events in all (the same for every device), set up."""
    import importlib

    import numpy as np

    from pisa_tpu_torch.testing import service_matrix as TSM

    service = importlib.import_module(
        f"pisa_tpu_torch.stages.xsec.{name}").init_test()
    for pname, value in MCEQ_XSEC[name].items():
        p = service.params[pname]
        p.value = value * p.units
    service.data = TSM.make_events_data(service, np.random.RandomState(0),
                                        device=device,
                                        n_events=n_events // 2)
    service.setup()
    return service


def xsec_card_vs_cpu(smi):
    """float64: dis_sys, genie_sys and correct_charm_y at MCEQ_XSEC_EVENTS
    synthetic events, card against CPU: the weights, and the gradient of
    a seeded weighted sum of them in the parameters (as tensors, the
    service in template mode); then on the card the apply captured in a
    CUDA graph (no host read) and replayed, against the eager weights."""
    import numpy as np
    import torch

    from pisa_tpu_torch import ureg

    for name, values in MCEQ_XSEC.items():
        results = {}
        for device in ("cpu", "cuda"):
            t0 = time.perf_counter()
            service = xsec_service(name, device, MCEQ_XSEC_EVENTS)
            setup_s = time.perf_counter() - t0
            service._template_mode = True
            names = sorted(values)
            vec = torch.tensor([values[n] for n in names],
                               dtype=torch.float64, device=device,
                               requires_grad=True)
            for pname, x in zip(names, vec.unbind()):
                p = service.params[pname]
                p._value = ureg.Quantity(x, p.units)
            start = {c.name: c["weights"] for c in service.data}
            service.run()
            weights = {c.name: c["weights"] for c in service.data}
            rng = np.random.RandomState(7)
            loss = sum((w * torch.as_tensor(rng.uniform(0.5, 1.5, tuple(
                w.shape)), device=device)).sum() for w in weights.values())
            grad = (torch.autograd.grad(loss, vec)[0].cpu().numpy() if names
                    else np.zeros(0))
            results[device] = ({k: w.detach().cpu().numpy()
                                for k, w in weights.items()}, grad, setup_s)
            if device == "cuda":
                # the apply captured: it reads nothing on the host
                for c in service.data:
                    c["weights"] = start[c.name]
                with torch.no_grad():
                    graph = torch.cuda.CUDAGraph()
                    stream = torch.cuda.Stream()
                    stream.wait_stream(torch.cuda.current_stream())
                    with torch.cuda.stream(stream):
                        service.apply_function()
                    torch.cuda.current_stream().wait_stream(stream)
                    for c in service.data:
                        c["weights"] = start[c.name]
                    with torch.cuda.graph(graph):
                        service.apply_function()
                    graph.replay()
                    torch.cuda.synchronize()
                replay = {c.name: c["weights"].cpu().numpy()
                          for c in service.data}
        (want, want_g, cpu_s), (got, got_g, card_s) = (results["cpu"],
                                                         results["cuda"])
        n = sum(w.size for w in got.values())
        err = max(float(np.abs(got[k] - want[k]).max()
                        / np.abs(want[k]).max()) for k in want)
        replay_err = max(float(np.abs(replay[k] - got[k]).max()
                               / np.abs(got[k]).max()) for k in got)
        gerr = (float(np.abs(got_g - want_g).max() / np.abs(want_g).max())
                if names else 0.0)
        moved = any(not np.allclose(w, 1.0) for w in got.values())
        print(f"float64 xsec.{name} at {n} synthetic events, card vs CPU:"
              f" weights {err:.3e} of the largest, gradient in {names}"
              f" {got_g.tolist()} at {gerr:.3e} of the largest (bound"
              f" {XSEC_RTOL:g}); the captured apply's replay {replay_err:.3e}"
              f" off the eager weights; set-up {card_s:.2f} s on the card,"
              f" {cpu_s:.2f} s on the CPU [{smi}]")
        check(n == MCEQ_XSEC_EVENTS and moved and err <= XSEC_RTOL
              and gerr <= XSEC_RTOL and replay_err <= XSEC_RTOL
              and np.all(np.isfinite(got_g)),
              f"xsec.{name}: the card is off the CPU")


def mceq_fp64(smi):
    """float64, card against CPU: the 20x20-grid MCEq flagship at full
    events (maps within TEMPLATE_RTOL, the captured mod_chi2 value_and_grad
    within VG_FP64), then the three cross-section services at
    MCEQ_XSEC_EVENTS synthetic events (xsec_card_vs_cpu)."""
    from pisa_tpu_torch.testing.mceq_flagship import mceq_flagship_config

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pipeline_card_vs_cpu("MCEq flagship, 20x20 grid",
                             lambda: mceq_flagship_config(tmp, 20), smi)
        print(f"float64 MCEq flagship: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    xsec_card_vs_cpu(smi)
    print(f"float64 xsec services: {time.perf_counter() - t0:.1f} s")


def mceq_worker():
    """float64 (``--mceq-worker``): mceq_fp64 in a child process, torch on
    HS_FP64_THREADS CPU threads (it runs beside the other children)."""
    import torch

    from pisa_tpu_torch import FTYPE_NAME

    check(FTYPE_NAME == "fp64", f"mceq worker runs {FTYPE_NAME}")
    torch.set_num_threads(HS_FP64_THREADS)
    smi = card_line()
    t0 = time.perf_counter()
    mceq_fp64(smi)
    print(f"float64 MCEq phase: {time.perf_counter() - t0:.1f} s [{smi}]")


def mceq_fp32(chain, smi):
    """The MCEq-Barr flagship at full width, float32, through the entry
    points (this slice's main path): the eager template; the compiled
    template's captured value_and_grad (measure_vg: wall, kernels per
    replay, busy share, peak memory, no wait inside the replay);
    Analysis().fit_recursively(..., 'device', {'max_steps': n}, ...) on the
    DistributionMaker's Asimov data from theta23 moved by +0.10 rescaled,
    for each n of MCEQ_FIT_STEPS. The counts are set to 0 just before
    each part and read just after; returns the sums of the chain kernels'
    launches."""
    import numpy as np
    import torch

    from pisa_tpu_torch import ureg
    from pisa_tpu_torch.analysis.analysis import Analysis, BasicAnalysis
    from pisa_tpu_torch.core.distribution_maker import DistributionMaker
    from pisa_tpu_torch.core.pipeline import Pipeline
    from pisa_tpu_torch.testing.mceq_flagship import write_mceq_flagship

    total = [0, 0, 0]

    def add():
        launches = launch_counts(chain)
        for i, n in enumerate(launches):
            total[i] += n
        reset_launch_counts(chain)
        return launches

    with tempfile.TemporaryDirectory() as tmp:
        cfg = write_mceq_flagship(tmp)
        reset_launch_counts(chain)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pipeline = Pipeline(cfg, device="cuda")
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        maps = pipeline.get_outputs()
        totals = [float(m.hist.sum()) for m in maps]
        first_s = time.perf_counter() - t0
        walls = []
        theta23 = pipeline.params["theta23"].value
        for i in range(5):
            pipeline.params["theta23"].value = theta23 + 0.1 * (i + 1) \
                * ureg.degree
            t0 = time.perf_counter()
            pipeline.get_outputs()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        pipeline.params["theta23"].value = theta23
        launches = add()
        print(f"float32 MCEq flagship: Pipeline set-up {setup_s:.2f} s, first"
              f" template {first_s:.2f} s, then get_outputs with an"
              f" oscillation recompute median {np.median(walls) * 1e3:.2f} ms"
              f" (5 runs), {sum(totals):.1f} expected events; launches"
              f" {launches}; peak memory"
              f" {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB [{smi}]")
        check(all(np.isfinite(t) and t > 0 for t in totals),
              "MCEq flagship: template not finite")
        check(launches == (12, 0, 0), f"MCEq flagship templates: launches"
              f" {launches}")
        del maps

        ct = pipeline.compile()
        check(not ct.stacked and len(ct.free_names) == MCEQ_FREE,
              f"MCEq flagship template: stacked {ct.stacked},"
              f" {len(ct.free_names)} free")
        vg_launches = measure_vg("MCEq flagship", ct, chain, smi)
        launches = add()
        print(f"MCEq flagship value_and_grad path: launches {launches} (the"
              f" eager run, the warm-ups and the capture) [{smi}]")
        check(vg_launches == (2, 0, 2), f"MCEq flagship value_and_grad"
              f" launches {vg_launches}")
        del ct, pipeline
        torch.cuda.empty_cache()

        # the device fit through the analysis layer
        dm = DistributionMaker([cfg], device="cuda")
        data = dm.get_outputs(return_sum=True)
        truth = dm.params["theta23"]._rescaled_value
        add()

        def fit(steps):
            dm.reset_free()
            dm.params["theta23"]._rescaled_value = min(0.95, truth + 0.10)
            return Analysis().fit_recursively(
                data, dm, "mod_chi2", None, "device", {"max_steps": steps},
                None)

        for steps in MCEQ_FIT_STEPS:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            waits, result = count_host_syncs(lambda: fit(steps))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            meta = result.minimizer_metadata
            moved = result.params["theta23"]._rescaled_value - truth
            launches = add()
            print(f"Analysis fit, MCEq flagship ({len(dm.params.free)} free),"
                  f" device (max_steps {steps}), float32: wall {wall:.3f} s"
                  f" with the set-up and capture of its objective (the first"
                  f" fit's), nit {meta['nit']}, nfev {meta['nfev']}, {waits}"
                  f" waits for the card ({waits / meta['nfev']:.2f} per"
                  f" evaluation), theta23 off the truth by {moved:.3e}"
                  f" rescaled (bound {FIT_TOL:g} at max_steps"
                  f" {MCEQ_FIT_STEPS[-1]}), metric {result.metric_val!r}; peak"
                  f" memory {torch.cuda.max_memory_allocated() / 2**20:.1f}"
                  f" MiB; launches {launches} [{smi}]")
        check(abs(moved) <= FIT_TOL, "the MCEq fit did not recover theta23")
        check(waits / meta["nfev"] <= DEVICE_FIT_WAITS,
              f"the MCEq fit waited {waits / meta['nfev']:.2f} times per"
              " evaluation")
        BasicAnalysis._compiled_cache.clear()
        del dm
        torch.cuda.empty_cache()
    print(f"MCEq path launches (primal, tangent, multitangent):"
          f" {tuple(total)} [{smi}]")
    check(total[0] > 0 and total[2] > 0, "the MCEq path launched no primal"
          " or no multitangent kernel")
    return tuple(total)


def param_service(case, device, n_events=PARAM_EVENTS):
    """The service of PARAM_SERVICES[case] at its values, on the service
    matrix's two containers with `n_events` synthetic events in all (a
    source service: an empty set), in template mode with its parameters as
    float64 tensors that require a gradient, set up; returns (service,
    the parameter names, their tensor)."""
    import importlib

    import numpy as np
    import torch

    from pisa_tpu_torch import ureg
    from pisa_tpu_torch.core import binning
    from pisa_tpu_torch.core.container import ContainerSet
    from pisa_tpu_torch.testing import service_matrix as TSM

    stage, name, options, _, values, overrides = PARAM_SERVICES[case]
    module = importlib.import_module(f"pisa_tpu_torch.stages.{stage}.{name}")
    if options is None:
        service = module.init_test()
    else:
        options = dict(options)
        if options.get("calc_mode") == "reco":
            # a binning of the reco variables, disjoint from TEST_BINNING's
            options["calc_mode"] = binning.MultiDimBinning([
                binning.OneDimBinning("reco_energy", num_bins=4, is_log=True,
                                      domain=[6, 80] * ureg.GeV),
                binning.OneDimBinning("reco_coszen", num_bins=3, is_lin=True,
                                      domain=[-1, 1]),
            ], name="reco_test")
            options["apply_mode"] = TSM.TEST_BINNING
        else:
            options["calc_mode"] = "events"
        service = getattr(module, name)(**options)
    if name in TSM.SOURCE_SERVICES:
        data = ContainerSet("test", device=device)
        data["output_binning"] = TSM.TEST_BINNING
    else:
        data = TSM.make_events_data(service, np.random.RandomState(0),
                                    device=device, n_events=n_events // 2)
    service.data = data
    for key, f in overrides.items():
        for c in data:
            c[key] = f(c[key].cpu().numpy())
    names = sorted(values)
    vec = torch.tensor([values[n] for n in names], dtype=torch.float64,
                       device=device, requires_grad=True)
    service.setup()
    service._template_mode = True
    for pname, x in zip(names, vec.unbind()):
        p = service.params[pname]
        p._value = ureg.Quantity(x, p.units)
    return service, names, vec


def param_services_card_vs_cpu(smi, devices=("cpu", "cuda")):
    """float64: each case of PARAM_SERVICES (the 13 services of the
    parameterized-detector slice from their init_test, hist's options) at
    PARAM_EVENTS synthetic events on each of `devices`: the outputs, and
    the gradient of a seeded weighted sum of them in each differentiable
    parameter; the second device's within XSEC_RTOL of the first's
    (PARAM_EXACT's random streams exactly). None of these services has a
    map mode (as in the JAX package)."""
    import numpy as np
    import torch

    from pisa_tpu_torch.testing import service_matrix as TSM

    for case, (stage, name, _, keys, _, _) in PARAM_SERVICES.items():
        results = []
        for device in devices:
            t0 = time.perf_counter()
            service, names, vec = param_service(case, device)
            service.run()
            outputs = {(c.name, k): c[k] for c in service.data for k in keys}
            rng = np.random.RandomState(7)
            loss = sum((v * torch.as_tensor(rng.uniform(0.5, 1.5, tuple(
                v.shape)), device=device)).sum()
                for v in outputs.values() if v.is_floating_point())
            grad = (torch.autograd.grad(loss, vec)[0].cpu().numpy()
                    if names else np.zeros(0))
            results.append(({k: v.detach().cpu().numpy()
                             for k, v in outputs.items()}, grad,
                            time.perf_counter() - t0))
        (want, want_g, cpu_s), (got, got_g, card_s) = results
        exact = case in PARAM_EXACT
        err = 0.0
        for key, ref in want.items():
            if exact or ref.dtype == np.bool_:
                err = max(err, float(np.any(got[key] != ref)))
            else:
                err = max(err, float(np.abs(got[key] - ref).max()
                                     / max(np.abs(ref).max(), 1e-300)))
        gerr = (float(np.abs(got_g - want_g).max() / np.abs(want_g).max())
                if names else 0.0)
        n = max(v.size for v in got.values())
        map_mode = ("ok" if (stage, name) in TSM.MAP_MODE_SERVICES
                    else "n/a")
        print(f"float64 {case} ({n} values a key), card vs CPU: outputs"
              f" {'equal' if exact and err == 0 else f'{err:.3e} of the largest'}"
              f" ({'exactly' if exact else f'bound {XSEC_RTOL:g}'}),"
              f" gradient in {names} {got_g.tolist()} at {gerr:.3e} of the"
              f" largest; map mode {map_mode}; set-up and run"
              f" {card_s:.2f} s on the card, {cpu_s:.2f} s on the CPU"
              f" [{smi}]")
        check(np.all([np.all(np.isfinite(v)) for v in got.values()
                      if v.dtype != np.bool_]) and np.all(np.isfinite(got_g)),
              f"{case}: not finite on the card")
        check(err == 0 if exact else err <= XSEC_RTOL,
              f"{case}: the card's outputs are off the CPU's by {err}")
        check(gerr <= XSEC_RTOL and (not names or np.all(got_g != 0)),
              f"{case}: the card's gradient is off the CPU's by {gerr}")


def param_reco_card_vs_cpu(smi, devices=("cpu", "cuda")):
    """float64: the parameterized-detector path at its full width
    (240,000 toy events): the reco variables that reco.simple_param draws
    and reco.resolutions moves, on each of `devices`; the second's equal to
    the first's."""
    import numpy as np

    from pisa_tpu_torch.core.pipeline import Pipeline
    from pisa_tpu_torch.testing.param_detector import param_detector_config

    reco = []
    for device in devices:
        t0 = time.perf_counter()
        config = param_detector_config()
        # the reco variables are drawn at set-up from the events alone: the
        # pipeline's loader and reco stages
        for key in [k for k in config if isinstance(k, tuple)]:
            if key[0] not in ("data", "reco"):
                del config[key]
        pipeline = Pipeline(config, device=device)
        values = {}
        for c in pipeline.data:
            c.representation = "events"
            for key in ("reco_energy", "reco_coszen", "pid"):
                values[(c.name, key)] = c[key].cpu().numpy()
        reco.append((values, time.perf_counter() - t0))
    (want, cpu_s), (got, card_s) = reco
    n = sum(v.size for (_, k), v in got.items() if k == "pid")
    same = all(np.array_equal(got[k], want[k]) for k in want)
    print(f"float64 parameterized detector's reco variables at {n} toy"
          f" events, card vs CPU: {'equal' if same else 'DIFFERENT'};"
          f" set-up {card_s:.1f} s on the card, {cpu_s:.1f} s on the CPU"
          f" [{smi}]")
    check(n == PARAM_EVENTS and same,
          "the card's reco variables are not the CPU's")


def param_fp64(smi):
    """float64, card against CPU: the parameterized-detector path at
    small=True (pipeline_card_vs_cpu: the 12 maps within TEMPLATE_RTOL of
    each map's largest bin, the captured mod_chi2 value_and_grad within
    VG_FP64), its reco variables at full width exactly, and each service
    and hist option (param_services_card_vs_cpu)."""
    from pisa_tpu_torch.testing.param_detector import param_detector_config

    t0 = time.perf_counter()
    pipeline_card_vs_cpu("parameterized detector, small",
                         lambda: param_detector_config(small=True), smi)
    print(f"float64 parameterized detector: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    param_reco_card_vs_cpu(smi)
    param_services_card_vs_cpu(smi)
    print(f"float64 parameterized-detector services:"
          f" {time.perf_counter() - t0:.1f} s")


def param_worker():
    """float64 (``--param-worker``): param_fp64 in a child process, torch on
    PARAM_FP64_THREADS CPU threads (it runs beside the other children)."""
    import torch

    from pisa_tpu_torch import FTYPE_NAME

    check(FTYPE_NAME == "fp64", f"param worker runs {FTYPE_NAME}")
    torch.set_num_threads(PARAM_FP64_THREADS)
    smi = card_line()
    t0 = time.perf_counter()
    param_fp64(smi)
    print(f"float64 parameterized-detector phase:"
          f" {time.perf_counter() - t0:.1f} s [{smi}]")


def param_multitangent(chain, cfg, smi):
    """tile_multi_kernel<S, 2> at the path's 200x200 calc grid (40,000
    points, PREM-12) along theta23 and Delta m^2_31, float32 and float64:
    against its plain version (nu and nubar at the nominal theta), then its
    device-only time (a CUDA graph of 200 launches, the better of two
    turns) beside its operation bound. (multitangent_vs_plain times the
    plain version, at K = 3.)"""
    import torch

    times = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        geom, params = flagship_geometry(dtype, cfg)
        args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
        tiles = geom["tiles"]
        thetas = flagship_thetas(params, 1)
        errs = {"p": 0.0, "t": 0.0}
        for theta in thetas:
            for nubar in (1, -1):
                pvec, dirs = pack_and_directions(chain, theta, nubar, dtype)
                dpvecs = dirs[list(PARAM_THETA)].contiguous()
                out, dout = chain.chain_multitangent(pvec, dpvecs, *args,
                                                     tiles)
                ref_p, ref_t = chain.chain_multitangent_reference(
                    pvec, dpvecs, *args)
                scale = ref_t.abs().amax(dim=(1, 2, 3), keepdim=True)
                errs["p"] = max(errs["p"], float((out - ref_p).abs().max()))
                errs["t"] = max(errs["t"], float(((dout - ref_t).abs()
                                                  / scale).max()))
        check(errs["p"] <= MULTI_PRIMAL_ATOL[dname]
              and errs["t"] <= TANGENT_RTOL[dname],
              f"{dname}: the K=2 multitangent is off its plain version by"
              f" {errs}")
        pvec, dirs = pack_and_directions(chain, thetas[0], 1, dtype)
        dpvecs = dirs[list(PARAM_THETA)].contiguous()
        run = lambda: chain.chain_multitangent(  # noqa: E731
            pvec, dpvecs, *args, tiles)
        device_ms = min(graph_time(run), graph_time(run))
        bound = kernel_bound(chain, geom, 2, True)
        times[dname] = device_ms
        print(f"time, osc_chain_multitangent {dname} (K=2, theta23 and"
              f" Delta m^2_31), the parameterized detector's"
              f" {geom['e'].shape[0]}-point grid, {tile_line(tiles)}:"
              f" {device_ms:.5f} ms device-only (CUDA graph, the better of"
              f" two); bound"
              f" {bound['bound_ms']:.5f} ms by {bound['bound_by']}"
              f" ({bound['ops']} operations):"
              f" {100 * bound['bound_ms'] / device_ms:.1f}% of it;"
              f" vs plain: primal {errs['p']:.3e} (bound"
              f" {MULTI_PRIMAL_ATOL[dname]:g} abs), tangents {errs['t']:.3e}"
              f" (bound {TANGENT_RTOL[dname]:g} rel) [{smi}]")
    return times


def param_fp32(chain, smi):
    """The parameterized-detector path at full width, float32, through the
    entry points (this slice's main path: 240,000 toy events, the 200x200
    calc grid, 4 free): the eager template (its wall with an oscillation
    recompute, its launches); the compiled template's captured
    value_and_grad (measure_vg: wall, device time, kernels a replay, busy
    share, no wait inside the replay) and one eager value_and_grad's
    launches; Analysis().fit_recursively(..., 'device', ...) on the
    DistributionMaker's Asimov data from theta23 moved by +0.10 rescaled;
    then tile_multi_kernel<S, 2> at the path's grid (param_multitangent,
    whose launches do not count). The counts are set to 0 just before each
    part and read just after; returns the sums of the chain kernels'
    launches."""
    import numpy as np
    import torch

    from pisa_tpu_torch import ureg
    from pisa_tpu_torch.analysis.analysis import Analysis, BasicAnalysis
    from pisa_tpu_torch.core.distribution_maker import DistributionMaker
    from pisa_tpu_torch.core.pipeline import Pipeline
    from pisa_tpu_torch.testing.param_detector import write_param_detector

    total = [0, 0, 0]

    def add():
        launches = launch_counts(chain)
        for i, n in enumerate(launches):
            total[i] += n
        reset_launch_counts(chain)
        return launches

    with tempfile.TemporaryDirectory() as tmp:
        cfg = write_param_detector(tmp)
        reset_launch_counts(chain)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pipeline = Pipeline(cfg, device="cuda")
        setup_s = time.perf_counter() - t0
        pipeline.data.representation = "events"
        n_events = sum(c.size for c in pipeline.data)
        t0 = time.perf_counter()
        maps = pipeline.get_outputs()
        totals = [float(m.hist.sum()) for m in maps]
        first_s = time.perf_counter() - t0
        add()
        walls = []
        theta23 = pipeline.params["theta23"].value
        for i in range(5):
            pipeline.params["theta23"].value = theta23 + 0.1 * (i + 1) \
                * ureg.degree
            t0 = time.perf_counter()
            pipeline.get_outputs()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        pipeline.params["theta23"].value = theta23
        launches = add()
        per_template = tuple(n // 5 for n in launches)
        print(f"float32 parameterized detector ({n_events} toy events,"
              f" {len(maps)} maps of {maps[0].hist.size} bins): Pipeline"
              f" set-up {setup_s:.2f} s, first template {first_s:.2f} s,"
              f" then get_outputs with an oscillation recompute median"
              f" {np.median(walls) * 1e3:.2f} ms (5 runs), {sum(totals):.1f}"
              f" expected events; launches a template {per_template}; peak"
              f" memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB"
              f" [{smi}]")
        check(n_events == PARAM_EVENTS and len(maps) == 12,
              f"parameterized detector: {n_events} events, {len(maps)} maps")
        check(all(np.isfinite(t) and t > 0 for t in totals),
              "parameterized detector: template not finite")
        check(launches == (10, 0, 0), f"parameterized detector templates:"
              f" launches {launches} in 5")
        del maps

        ct = pipeline.compile()
        check(not ct.stacked and len(ct.free_names) == PARAM_FREE,
              f"parameterized detector template: stacked {ct.stacked},"
              f" {len(ct.free_names)} free")
        vg_launches = measure_vg("parameterized detector", ct, chain, smi)
        launches = add()
        print(f"parameterized detector value_and_grad path: launches"
              f" {launches} (the eager run, the warm-ups and the capture)"
              f" [{smi}]")
        check(vg_launches == (2, 0, 2), f"parameterized detector"
              f" value_and_grad launches {vg_launches}")
        del ct, pipeline
        torch.cuda.empty_cache()

        # the device fit through the analysis layer
        dm = DistributionMaker([cfg], device="cuda")
        data = dm.get_outputs(return_sum=True)
        truth = dm.params["theta23"]._rescaled_value
        add()
        dm.params["theta23"]._rescaled_value = min(0.95, truth + 0.10)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        waits, result = count_host_syncs(
            lambda: Analysis().fit_recursively(data, dm, "mod_chi2", None,
                                               "device", {}, None))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        meta = result.minimizer_metadata
        moved = result.params["theta23"]._rescaled_value - truth
        launches = add()
        print(f"Analysis fit, parameterized detector"
              f" ({len(dm.params.free)} free), device, float32: wall"
              f" {wall:.3f} s with the set-up and capture of its objective,"
              f" nit {meta['nit']}, nfev {meta['nfev']}, {waits} waits for"
              f" the card ({waits / meta['nfev']:.2f} per evaluation),"
              f" theta23 off the truth by {moved:.3e} rescaled (bound"
              f" {FIT_TOL:g}), metric {result.metric_val!r}; peak memory"
              f" {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB;"
              f" launches {launches} [{smi}]")
        check(abs(moved) <= FIT_TOL, "the parameterized-detector fit did not"
              " recover theta23")
        check(waits / meta["nfev"] <= DEVICE_FIT_WAITS,
              f"the parameterized-detector fit waited"
              f" {waits / meta['nfev']:.2f} times per evaluation")
        BasicAnalysis._compiled_cache.clear()
        del dm
        torch.cuda.empty_cache()
        print(f"parameterized-detector path launches (primal, tangent,"
              f" multitangent): {tuple(total)} [{smi}]")
        check(total[0] > 0 and total[2] > 0, "the parameterized-detector"
              " path launched no primal or no multitangent kernel")
        param_multitangent(chain, cfg, smi)
    reset_launch_counts(chain)
    return tuple(total)


def param_only_main(chain, smi):
    """``--param-only``: the kernels built, then the parameterized-detector
    phases alone (the float64 child's and the main process's); no status
    line."""
    run_children([("parameterized detector", ["--param-worker"])])
    t0 = time.perf_counter()
    launches = param_fp32(chain, smi)
    print(f"float32 parameterized-detector phase:"
          f" {time.perf_counter() - t0:.1f} s; launches {launches}")
    return 0


def mceq_only_main(chain, smi):
    """``--mceq-only``: the kernels built, then the MCEq-Barr flagship's
    phases alone (the float64 child's and the main process's); no status
    line."""
    run_children([("MCEq", ["--mceq-worker"])])
    t0 = time.perf_counter()
    launches = mceq_fp32(chain, smi)
    print(f"float32 MCEq phase: {time.perf_counter() - t0:.1f} s; launches"
          f" {launches}")
    return 0


def sterile_only_main(chain, smi):
    """``--sterile-only``: the kernels built, herm4_eig held and timed, then
    the 3+1 phases alone (the float64 child's and the main process's); no
    status line."""
    t0 = time.perf_counter()
    herm4_vs_plain(smi)
    sterile_resonance_fp32(smi)
    print(f"herm4_eig checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--sterile-worker"],
                   env=dict(os.environ, PISA_TPU_FTYPE="fp64"), check=True)
    print(f"float64 child (sterile): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = sterile_fp32(chain, smi)
    print(f"float32 sterile phase: {time.perf_counter() - t0:.1f} s;"
          f" launches {launches}")
    return 0


# -- the HDF5 event path and the KDE stage --------------------------------------
def kde_stage_plan(dtype):
    """kde_example's KDE stage as set up (its regularized binning: log
    reco energy, reco coszen, pid) and the plan of its histograms on the
    card: the 1,320 points of the oversampled, reflected grid."""
    from pisa_tpu_torch.config.parser import parse_pipeline_config
    from pisa_tpu_torch.stages.utils.kde import kde
    from pisa_tpu_torch.utils.kde import KDEPlan

    settings = dict(parse_pipeline_config(KDE_CFG)[("utils", "kde")])
    stage = kde(**settings)
    stage.setup_function()
    return stage, KDEPlan(
        stage.regularized_apply_mode, coszen_name=stage.coszen_name,
        coszen_reflection=stage.coszen_reflection,
        oversample=stage.oversample, stack_pid=True, device="cuda",
        dtype=dtype)


def kde_live_counts(n):
    """Each of kde_example's 24 channels' live samples (12 categories in
    make_toy_events' order x the PID channels [-1000, 0) and [0, 1000))
    out of `n` events a category, from a seeded draw of make_toy_events'
    PID rule (scripts/make_toy_events.py: nu_mu and nu_mu-bar CC uniform on
    [0, 3), all tracks; every other category uniform on [-3, 1), about 3/4
    cascades)."""
    import numpy as np

    rng = np.random.RandomState(TOY_SEED)
    counts = []
    for flav in ("nue", "nue_bar", "numu", "numu_bar", "nutau",
                 "nutau_bar"):
        for int_type in ("cc", "nc"):
            pid = rng.uniform(0, 3, n) if flav.startswith("numu") and \
                int_type == "cc" else rng.uniform(-3, 1, n)
            counts += [int((pid < 0).sum()), int((pid >= 0).sum())]
    return counts


# kde_inputs' results, made once for both KDE kernel checks
_KDE_INPUTS = {}


def kde_inputs(dtype, live=False):
    """Full-width inputs of the KDE kernels, float64 on the card: 24
    channels (12 categories x 2 PID channels) of TOY_EVENTS samples in (log
    reco energy, reco coszen) from a seed, their bandwidths, the pilot's
    coefficients, the widths and coefficients of the pass at kde_example's
    1,320 grid points (utils/kde.py and ops/kde.py form them so), and
    cotangents for both vjps. Dense (``counts`` None): every sample live,
    channel 1 without weight. With `live`: each channel's first
    kde_live_counts(TOY_EVENTS) samples live (the layout that
    utils/kde.py:KDEPlan hands the kernels), the rest without weight and
    left out of every sum through ``counts``."""
    import numpy as np
    import torch

    from pisa_tpu_torch.ops import kde as ops_kde
    from pisa_tpu_torch.utils.kde import kde_bandwidths

    if (dtype, live) in _KDE_INPUTS:
        return _KDE_INPUTS[(dtype, live)]
    stage, plan = kde_stage_plan(torch.float64)
    rng = np.random.RandomState(TOY_SEED)
    B, N = 24, TOY_EVENTS
    x = np.stack([rng.normal(3.0, 0.8, (B, N)), rng.uniform(-1, 1, (B, N))],
                 axis=1)
    w = rng.uniform(0.5, 1.5, (B, N))
    if live:
        n_live = np.asarray(kde_live_counts(N))
        w[np.arange(N)[None, :] >= n_live[:, None]] = 0.0
    else:
        w[1] = 0.0

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float64, device="cuda")

    counts = torch.as_tensor(n_live, dtype=torch.int32, device="cuda") \
        if live else None
    x, wn, h = kde_bandwidths(dev(x), dev(w), stage.bw_method)
    ih = 1.0 / h
    ones = torch.ones_like(wn)
    q = ops_kde._widths(x, wn, h, ones, False, stage.alpha)
    pilot = ops_kde.gauss_sum_reference(x, x, ih, ones, q["c0"], counts,
                                        counts)
    q = ops_kde._widths(x, wn, h, pilot, True, stage.alpha)
    _KDE_INPUTS[(dtype, live)] = {
        "x": x.contiguous(), "w": wn, "h": h, "points": plan.points,
        "ih": ih, "ones": ones, "c0": q["c0"], "il2": q["il2"], "c": q["c"],
        "g_pilot": dev(rng.normal(size=(B, N))),
        "g_grid": dev(rng.normal(size=(B, plan.points.shape[1]))),
        "alpha": stage.alpha, "counts": counts,
    }
    return _KDE_INPUTS[(dtype, live)]


def kde_kernel_cases(inp):
    """The kernels' four calls of one adaptive KDE: (kernel, label,
    points-shared flag, its arguments, n_live, m_live)."""
    x, n = inp["x"], inp["counts"]
    return (
        ("sum", "pilot", False, (x, x, inp["ih"], inp["ones"], inp["c0"]),
         n, n),
        ("sum", "grid", True, (x, inp["points"], inp["ih"], inp["il2"],
                               inp["c"]), n, None),
        ("vjp", "pilot", False, (x, x, inp["ih"], inp["ones"],
                                 inp["g_pilot"]), n, n),
        ("vjp", "grid", True, (x, inp["points"], inp["ih"], inp["il2"],
                               inp["g_grid"]), n, None),
    )


def kde_vs_plain(smi):
    """kde_gauss_sum and kde_gauss_sum_vjp against their plain versions on
    the card at the full-width shapes (B = 24, N = TOY_EVENTS, the pilot's
    M = N and the grid's M = 1,320), float64 and float32 (the float32
    kernel against the float32 and the float64 plain version), in two
    cases: dense (every sample live, a channel without weight: zeros and
    finite vjps) and live (kde_example's PID split, kde_live_counts: empty
    channels give zeros); the float64 directional derivative of the whole
    density (ops/kde.py:AdaptiveDensity) against central differences;
    device-only times (a CUDA graph of 20 launches) beside the plain
    versions' (the one call whose result is the reference), the bound on
    the live pairs and the dense bound with their
    shares, registers, blocks per SM, outputs per thread (R) and the split
    count. Returns {kernel name: {dtype: line}}: the live pilot's, with the
    live grid's under "grid" and the dense pilot's and grid's under
    "dense" and "dense_grid"."""
    import numpy as np
    import torch

    from pisa_tpu_torch.ops import kde as ops_kde

    out = {"kde_gauss_sum": {}, "kde_gauss_sum_vjp": {}}
    inputs = {}
    plain64 = {}
    for case in ("dense", "live"):
        inp = inputs[case] = kde_inputs(torch.float64, live=case == "live")
        B, D, N = inp["x"].shape
        live = inp["w"].sum(-1) > 0  # the channels with weight
        counts = inp["counts"]
        n_rows = [N] * B if counts is None else counts.tolist()
        for dname, dtype in (("float64", torch.float64),
                             ("float32", torch.float32)):
            for kind, label, shared, args, n_live, m_live in \
                    kde_kernel_cases(inp):
                name = "kde_gauss_sum" if kind == "sum" \
                    else "kde_gauss_sum_vjp"
                kernel = ops_kde.gauss_sum if kind == "sum" \
                    else ops_kde.gauss_sum_vjp
                plain = ops_kde.gauss_sum_reference if kind == "sum" \
                    else ops_kde.gauss_sum_vjp_reference
                cast = tuple(a.to(dtype).contiguous() for a in args)
                got = kernel(*cast, n_live, m_live)
                want, plain_ms = timed_once(
                    lambda: plain(*cast, n_live, m_live))
                # the float64 pass's plain result, kept for the float32 one
                want64 = plain64.setdefault((case, kind, label), want)
                got, want, want64 = ((t,) if kind == "sum" else t
                                     for t in (got, want, want64))
                err = max(float((g.double() - p.double()).abs().max()
                                / p.double().abs().max())
                          for g, p in zip(got, want))
                # against float64 the channels with weight only: an empty
                # channel's vjp (k and u^2 at h = 1e-30, which the chain
                # rule multiplies by its zero coefficients) overflows in
                # float32
                err64 = max(float((g[live].double() - p[live]).abs().max()
                                  / p[live].abs().max())
                            for g, p in zip(got, want64))
                abs_err = max(float((g.double() - p.double()).abs().max())
                              for g, p in zip(got, want))
                finite = all(bool(torch.isfinite(g).all()) for g in got)
                zero = max(float(g[~live].abs().max()) for g in got) \
                    if kind == "sum" or case == "live" else 0.0
                check(finite, f"{name} {case} {label} {dname}: not finite")
                check(zero == 0.0, f"{name} {case} {label} {dname}: a"
                      " channel without weight or live sample is not zero")
                check(err <= KDE_KERNEL_RTOL[dname] and
                      err64 <= KDE_KERNEL_RTOL[dname],
                      f"{name} {case} {label} {dname}: {err:.3e} /"
                      f" {err64:.3e} off the plain version")
                M = cast[1].shape[-1]
                splits = ops_kde.launch_splits(
                    kind, D, dtype, B, M if kind == "sum" else N,
                    N if kind == "sum" else M)
                ms = graph_time(lambda: kernel(*cast, n_live, m_live),
                                launches=20, replays=3)
                m_rows = None if m_live is None else n_rows
                bound, by = ops_kde.kde_bound_ms(
                    kind, B, D, N, M, dtype, shared_points=shared,
                    n_live=n_rows, m_live=m_rows)
                dense_bound, _ = ops_kde.kde_bound_ms(
                    kind, B, D, N, M, dtype, shared_points=shared)
                attrs = ops_kde.kernel_attributes(kind, D, dtype)
                ops = ops_kde.kde_operations(kind, B, D, N, M, n_rows,
                                             m_rows)
                print(f"kernel {name} {dname}, {case} {label} (B={B},"
                      f" D={D}, N={N}, M={M}; {ops['pairs']} live pairs of"
                      f" {B * N * M}): max |kernel - plain| {err:.3e} of"
                      f" the largest (vs plain float64 {err64:.3e} over the"
                      f" channels with weight, bound"
                      f" {KDE_KERNEL_RTOL[dname]:g}); device-only"
                      f" {ms:.4f} ms, plain {plain_ms:.3f} ms; bound on the"
                      f" live pairs {bound:.4f} ms by {by}"
                      f" ({100 * bound / ms:.1f}% of it), dense bound"
                      f" {dense_bound:.4f} ms ({100 * dense_bound / ms:.1f}%);"
                      f" {attrs['registers']} registers, {attrs['local_bytes']}"
                      f" local bytes, {attrs['blocks_per_sm']} blocks of"
                      f" {attrs['threads']} per SM, R ="
                      f" {attrs['outputs_per_thread']}, {splits} split(s)"
                      f" [{smi}]")
                line = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": by, "dense_bound_ms": dense_bound,
                        "max_rel_err": err, "pairs": ops["pairs"],
                        "splits": splits, "shape": [B, D, N, M]}
                if label == "pilot":
                    line.update(
                        max_abs_err=abs_err, max_rel_err_vs_float64=err64,
                        registers=attrs["registers"],
                        local_bytes=attrs["local_bytes"],
                        threads=attrs["threads"],
                        blocks_per_sm=attrs["blocks_per_sm"],
                        outputs_per_thread=attrs["outputs_per_thread"])
                entry = out[name].setdefault(dname, {})
                if case == "live":
                    if label == "pilot":
                        entry.update(line)
                    else:
                        entry["grid"] = line
                else:
                    entry["dense" if label == "pilot" else "dense_grid"] = \
                        line
    # float64: the density's backward against central differences along a
    # seeded direction in (w, h), for a seeded cotangent (dense inputs)
    inp = inputs["dense"]
    B, D, N = inp["x"].shape
    rng = np.random.RandomState(1)
    w = inp["w"].detach().clone().requires_grad_(True)
    h = inp["h"].detach().clone().requires_grad_(True)
    g = torch.as_tensor(rng.normal(size=(B, inp["points"].shape[1])),
                        device="cuda")
    dw = inp["w"] * torch.as_tensor(rng.uniform(-1, 1, (B, N)),
                                    device="cuda")
    dh = inp["h"] * torch.as_tensor(rng.uniform(-1, 1, (B, D)),
                                    device="cuda")

    def f(w_, h_):
        return ops_kde.adaptive_density(inp["x"], w_, h_, inp["points"],
                                        True, inp["alpha"])

    (f(w, h) * g).sum().backward()
    analytic = float((w.grad * dw).sum() + (h.grad * dh).sum())
    eps = KDE_FD["step"]
    with torch.no_grad():
        numeric = float(((f(inp["w"] + eps * dw, inp["h"] + eps * dh)
                          - f(inp["w"] - eps * dw, inp["h"] - eps * dh))
                         * g).sum()) / (2 * eps)
    fd = abs(analytic - numeric) / abs(numeric)
    finite = bool(torch.isfinite(w.grad).all() and torch.isfinite(
        h.grad).all())
    print(f"float64 KDE density, directional derivative: backward"
          f" {analytic!r}, central differences (step {eps:g} relative)"
          f" {numeric!r}, relative difference {fd:.3e} (bound"
          f" {KDE_FD['rtol']:g}); gradient finite with a channel without"
          f" weight: {finite} [{smi}]")
    check(fd <= KDE_FD["rtol"] and finite,
          "the KDE density's backward is off its central differences")
    return out


def kde_jvp_vs_plain(smi):
    """kde_gauss_sum_jvp against its plain version (gauss_sum_jvp_reference)
    on the card at the full-width shapes (B = 24, N = TOY_EVENTS; the
    pilot at the samples with il2 = 1 and dil2 = 0, and the 1,320 grid
    points), at K = 1 and K = KDE_JVP_K (the Fisher matrix's directions; K
    = 1 takes the first of them), dense (a channel without weight: zeros)
    and with kde_example's live counts (kde_live_counts; empty channels give
    zeros), float64 and float32 (against the float32 and the float64 plain
    version), seeded tangents (KDE_JVP_DIRECTION). Timed (device-only, a
    CUDA graph of 20 launches, beside the plain version's one call, the
    K-aware bound on the live pairs and its share, registers and blocks per
    SM): the dense pilot at K = 1 in both types (the earlier design's
    shape; its plain version at K = 1 in float32, at KDE_JVP_K in float64)
    and, in float32, the live pilot and grid at K = 1 and K = KDE_JVP_K
    (their plain version's call at KDE_JVP_K); the other passes are checks
    only. Then the float64 density's
    forward mode (AdaptiveDensity's jvp, two jvp launches) against central
    differences and against its backward (<g, J t> = <J^T g, t>). Returns
    {dtype: line} of the dense pilot at K = 1, with the float32 live passes
    under "live_pilot", "live_grid" (K = 1), "live_pilot_K3" and
    "live_grid_K3" (K = KDE_JVP_K), and every pass's errors under
    "checks"."""
    import numpy as np
    import torch

    from pisa_tpu_torch.ops import kde as ops_kde

    K = KDE_JVP_K
    rng = np.random.RandomState(2)

    def direction(t):
        return t * torch.as_tensor(
            rng.uniform(-KDE_JVP_DIRECTION, KDE_JVP_DIRECTION,
                        (K,) + tuple(t.shape)), device="cuda")

    cases = []
    for case in ("dense", "live"):
        inp = kde_inputs(torch.float64, live=case == "live")
        x, n = inp["x"], inp["counts"]
        dih = direction(inp["ih"])
        zeros = torch.zeros((K,) + tuple(inp["ones"].shape),
                            dtype=torch.float64, device="cuda")
        cases += [
            (case, "pilot", False, (x, x, inp["ih"], dih, inp["ones"], zeros,
                                    inp["c0"], direction(inp["c0"])), n, n,
             inp["w"].sum(-1) > 0),
            (case, "grid", True, (x, inp["points"], inp["ih"], dih,
                                  inp["il2"], direction(inp["il2"]), inp["c"],
                                  direction(inp["c"])), n, None,
             inp["w"].sum(-1) > 0),
        ]

    def first(args):  # the first direction of each tangent
        return tuple(a[:1] if i in (3, 5, 7) else a
                     for i, a in enumerate(args))

    out = {}
    want64 = {}
    for dname, dtype in (("float64", torch.float64),
                         ("float32", torch.float32)):
        line = {"checks": {}}
        for case, label, shared, args, n_live, m_live, live in cases:
            cast = tuple(a.to(dtype).contiguous() for a in args)
            want, plain_ms = timed_once(
                lambda: ops_kde.gauss_sum_jvp_reference(*cast, n_live,
                                                        m_live))
            want64.setdefault((case, label), want)
            B, D, N = cast[0].shape
            M = cast[1].shape[-1]
            n_rows = None if n_live is None else n_live.tolist()
            m_rows = None if m_live is None else n_rows
            for k in (1, K):
                kargs = cast if k == K else first(cast)
                head = case == "dense" and label == "pilot" and k == 1
                timed = head or (case == "live" and dname == "float32")
                kwant, plain_k = want, K
                if head and dname == "float32":
                    # the plain version at the earlier design's shape, for
                    # the kernels line (float64 keeps the call at K)
                    kwant, plain_ms = timed_once(
                        lambda: ops_kde.gauss_sum_jvp_reference(
                            *kargs, n_live, m_live))
                    plain_k = 1
                got = ops_kde.gauss_sum_jvp(*kargs, n_live, m_live)
                triples = [(got[0], kwant[0], want64[(case, label)][0])] + [
                    (got[1][i], kwant[1][i], want64[(case, label)][1][i])
                    for i in range(k)]
                err = max(float((g.double() - p.double()).abs().max()
                                / p.double().abs().max())
                          for g, p, _ in triples)
                err64 = max(float((g[live].double() - p[live]).abs().max()
                                  / p[live].abs().max())
                            for g, _, p in triples)
                abs_err = max(float((g.double() - p.double()).abs().max())
                              for g, p, _ in triples)
                finite = all(bool(torch.isfinite(g).all()) for g in got)
                zero = max(float(g[..., ~live, :].abs().max()) for g in got)
                tag = f"{case} {label}, K = {k}"
                check(finite, f"kde_gauss_sum_jvp {tag} {dname}: not finite")
                check(zero == 0.0, f"kde_gauss_sum_jvp {tag} {dname}: a"
                      " channel without weight or live sample is not zero")
                check(err <= KDE_KERNEL_RTOL[dname]
                      and err64 <= KDE_KERNEL_RTOL[dname],
                      f"kde_gauss_sum_jvp {tag} {dname}: {err:.3e} /"
                      f" {err64:.3e} off the plain version")
                line["checks"][f"K{k}_{case}_{label}"] = {
                    "max_rel_err": err, "max_rel_err_vs_float64": err64}
                text = (f"kernel kde_gauss_sum_jvp {dname}, {tag} (B={B},"
                        f" D={D}, N={N}, M={M}): max |kernel - plain|"
                        f" {err:.3e} of the largest, value and tangents (vs"
                        f" plain float64 {err64:.3e} over the channels with"
                        f" weight, bound {KDE_KERNEL_RTOL[dname]:g})")
                if not timed:
                    print(f"{text}; not timed [{smi}]")
                    continue
                ms = graph_time(lambda: ops_kde.gauss_sum_jvp(
                    *kargs, n_live, m_live), launches=20, replays=3)
                bound, by = ops_kde.kde_bound_ms(
                    "jvp", B, D, N, M, dtype, shared_points=shared,
                    n_live=n_rows, m_live=m_rows, directions=k)
                attrs = ops_kde.kernel_attributes("jvp", D, dtype,
                                                  directions=k)
                splits = ops_kde.launch_splits("jvp", D, dtype, B, M, N,
                                               directions=k)
                ops = ops_kde.kde_operations("jvp", B, D, N, M, n_rows,
                                             m_rows, directions=k)
                print(f"{text}; {ops['pairs']} live pairs of {B * N * M};"
                      f" device-only {ms:.4f} ms ({ms / k:.4f} a direction),"
                      f" plain at K = {plain_k} {plain_ms:.3f} ms, bound {bound:.4f} ms by {by}"
                      f" ({ops['flops']} operations and {ops['exps']} exps;"
                      f" {100 * bound / ms:.1f}% of it);"
                      f" {attrs['registers']} registers,"
                      f" {attrs['local_bytes']} local bytes,"
                      f" {attrs['blocks_per_sm']} blocks of"
                      f" {attrs['threads']} per SM, R ="
                      f" {attrs['outputs_per_thread']}, {splits} split(s)"
                      f" [{smi}]")
                timing = {"ms": ms, "plain_ms": plain_ms,
                          "plain_directions": plain_k, "bound_ms": bound,
                          "bound_by": by, "max_rel_err": err,
                          "shape": [B, D, N, M], "directions": k,
                          "pairs": ops["pairs"], "splits": splits,
                          "registers": attrs["registers"],
                          "blocks_per_sm": attrs["blocks_per_sm"]}
                if head:
                    line.update(timing, max_abs_err=abs_err,
                                max_rel_err_vs_float64=err64,
                                local_bytes=attrs["local_bytes"],
                                threads=attrs["threads"])
                else:
                    line[f"live_{label}" + ("" if k == 1 else f"_K{k}")] = \
                        timing
        out[dname] = line
    del want64, cases
    # float64: the density's forward mode along a seeded direction in (w, h)
    inp = kde_inputs(torch.float64)
    x, w, h = inp["x"], inp["w"], inp["h"]
    B, D, N = x.shape
    dw = w * torch.as_tensor(rng.uniform(-1, 1, (B, N)), device="cuda")
    dh = h * torch.as_tensor(rng.uniform(-1, 1, (B, D)), device="cuda")
    g = torch.as_tensor(rng.normal(size=(B, inp["points"].shape[1])),
                        device="cuda")

    def f(w_, h_):
        return ops_kde.adaptive_density(x, w_, h_, inp["points"], True,
                                        inp["alpha"])

    before = ops_kde.jvp_launch_count
    _, tangent = torch.func.jvp(f, (w, h), (dw, dh))
    jvp_launches = ops_kde.jvp_launch_count - before
    forward = float((tangent * g).sum())
    w_, h_ = (t.detach().clone().requires_grad_(True) for t in (w, h))
    (f(w_, h_) * g).sum().backward()
    reverse = float((w_.grad * dw).sum() + (h_.grad * dh).sum())
    eps = KDE_FD["step"]
    with torch.no_grad():
        numeric = float(((f(w + eps * dw, h + eps * dh)
                          - f(w - eps * dw, h - eps * dh)) * g).sum()) / (
                              2 * eps)
    fd = abs(forward - numeric) / abs(numeric)
    transpose = abs(forward - reverse) / abs(reverse)
    print(f"float64 KDE density, forward mode: <g, J t> {forward!r} against"
          f" central differences (step {eps:g} relative) {numeric!r}"
          f" ({fd:.3e}, bound {KDE_FD['rtol']:g}) and the backward's"
          f" <J^T g, t> {reverse!r} ({transpose:.3e}); jvp launches"
          f" {jvp_launches} [{smi}]")
    check(fd <= KDE_FD["rtol"] and transpose <= KDE_KERNEL_RTOL["float64"]
          and bool(torch.isfinite(tangent).all()),
          "the KDE density's jvp is off its central differences or its"
          " backward")
    check(jvp_launches == 2, f"the density's jvp launched {jvp_launches}"
          " jvp kernels")
    return out


def toy_config(cfg_path, events):
    """`cfg_path` parsed, its loader's events_file the mapping `events` (or,
    for an int, scripts/make_toy_events.py's events of that many per
    flavour and interaction from TOY_SEED: 12 categories)."""
    from pisa_tpu_torch.config.parser import parse_pipeline_config
    from pisa_tpu_torch.scripts.make_toy_events import make_toy_events

    if isinstance(events, int):
        events = make_toy_events(num_events=events, seed=TOY_SEED)
    cfg = parse_pipeline_config(cfg_path)
    cfg[("data", "simple_data_loader")]["events_file"] = events
    return cfg


def maps_rel(got, want):
    """Worst |got - want| over a map's bins, relative to that map's largest
    bin, over every map (lists of MapSets for a VarBinning)."""
    import numpy as np

    if isinstance(want, list):
        return max(maps_rel(g, w) for g, w in zip(got, want))
    worst = 0.0
    for m in want:
        ref = np.asarray(m.hist)
        scale = np.abs(ref).max()
        if scale > 0:
            worst = max(worst, float(np.abs(got[m.name].hist - ref).max()
                                     / scale))
    return worst


def vg_card_vs_cpu(label, cpu_pipeline, gpu_pipeline, smi):
    """The compiled mod_chi2 value_and_grad at gradient_point, on the card
    (stacked and captured) against the CPU (float64), the CPU's eager maps
    as data for both, within VG_FP64."""
    import numpy as np
    import torch

    data = {m.name: m.hist for m in cpu_pipeline.get_outputs()}
    cpu_ct = cpu_pipeline.compile()
    gpu_ct = gpu_pipeline.compile()
    check(cpu_ct.free_names == gpu_ct.free_names and gpu_ct.stacked,
          f"{label}: the templates differ")
    v = gradient_point(cpu_ct)
    _, cpu_vg = cpu_ct.build_objective(data, "mod_chi2")
    want = read_back(cpu_vg(v))
    _, gpu_vg = gpu_ct.build_objective(data, "mod_chi2")
    got = read_back(gpu_vg(v))
    value_rel = abs(got[0] - want[0]) / abs(want[0])
    grad = grad_mismatch(got[1:], want[1:], VG_FP64["grad_rtol"],
                         VG_FP64["grad_atol"])
    print(f"float64 {label}, captured value_and_grad ({len(gpu_ct.free_names)}"
          f" free, stacked) card vs CPU: value {value_rel:.3e} relative"
          f" (bound {VG_FP64['value']:g}), gradient at {grad:.3e} of its"
          f" bound [{smi}]")
    check(value_rel <= VG_FP64["value"] and grad <= 1.0
          and np.all(np.isfinite(got)),
          f"{label}: the card's value_and_grad is off the CPU's")
    del cpu_ct, gpu_ct
    torch.cuda.empty_cache()


def events_worker():
    """float64: the four configs that read the repo's HDF5 events file,
    card against CPU, read by the port's reader with h5py made unimportable
    in this process; kde_example's compiled value_and_grad card vs CPU,
    and the full-width path's at TOY_EVENTS_FP64 events per category."""
    import importlib.util

    installed = importlib.util.find_spec("h5py") is not None
    sys.modules["h5py"] = None  # whatever the machine has: the port's reader
    from pisa_tpu_torch import FTYPE_NAME
    from pisa_tpu_torch.core.pipeline import Pipeline
    from pisa_tpu_torch.utils import hdf5_reader

    check(FTYPE_NAME == "fp64", f"events worker runs {FTYPE_NAME}")
    smi = card_line()
    t0 = time.perf_counter()
    print(f"HDF5 reader: {hdf5_reader.__name__}"
          f" ({os.path.relpath(hdf5_reader.__file__, ROOT)}); h5py installed"
          f" on this machine: {installed}, importable in this process:"
          f" False")
    pipelines = {}
    for name in HDF5_CFGS:
        path = f"settings/pipeline/{name}.cfg"
        cpu = Pipeline(path, device="cpu")
        gpu = Pipeline(path, device="cuda")
        rel = maps_rel(gpu.get_outputs(), cpu.get_outputs())
        print(f"float64 {name}.cfg from the repo's HDF5 file, card vs CPU:"
              f" worst bin {rel:.3e} of its map's largest (bound"
              f" {TEMPLATE_RTOL['float64']:g}) [{smi}]")
        check(rel <= TEMPLATE_RTOL["float64"],
              f"{name}.cfg: the card's maps are off the CPU's")
        pipelines[name] = (cpu, gpu)
    check("h5py" not in [m for m, v in sys.modules.items() if v is not None],
          "h5py was imported")
    vg_card_vs_cpu("kde_example", *pipelines["kde_example"], smi)
    del pipelines
    cfg = toy_config(KDE_CFG, TOY_EVENTS_FP64)
    cpu, gpu = Pipeline(cfg, device="cpu"), Pipeline(cfg, device="cuda")
    rel = maps_rel(gpu.get_outputs(), cpu.get_outputs())
    print(f"float64 kde_example at {TOY_EVENTS_FP64} toy events per"
          f" category, card vs CPU: worst bin {rel:.3e} of its map's largest"
          f" (bound {TEMPLATE_RTOL['float64']:g}) [{smi}]")
    check(rel <= TEMPLATE_RTOL["float64"],
          "kde_example (toy events): the card's maps are off the CPU's")
    vg_card_vs_cpu(f"kde_example at {TOY_EVENTS_FP64} toy events per"
                   " category", cpu, gpu, smi)
    kde_fisher_card_vs_cpu(cpu, gpu, smi)
    print(f"float64 events phase: {time.perf_counter() - t0:.1f} s [{smi}]")


def kde_fisher_card_vs_cpu(cpu_pipeline, gpu_pipeline, smi):
    """float64: get_fisher_matrix (jacfwd through the KDE density's forward
    mode) of the compiled template on the card against the CPU's, within
    KDE_FISHER_RTOL of the largest entry; the card's KDE launches."""
    import numpy as np

    from pisa_tpu_torch.analysis.fisher import get_fisher_matrix

    want = get_fisher_matrix(cpu_pipeline.compile())
    gpu_ct = gpu_pipeline.compile()
    get_fisher_matrix(gpu_ct)  # the first call builds the cached tensors
    reset_kde_launches()
    got = get_fisher_matrix(gpu_ct)
    kde = kde_launches()
    rel = float(np.abs(got.matrix - want.matrix).max()
                / np.abs(want.matrix).max())
    print(f"float64 kde_example Fisher matrix at {TOY_EVENTS_FP64} toy events"
          f" per category ({len(got.parameters)} params), card vs CPU:"
          f" {rel:.3e} of the largest entry (bound {KDE_FISHER_RTOL:g}); card"
          f" KDE launches (sum, vjp, jvp) {kde} [{smi}]")
    check(got.parameters == want.parameters and rel <= KDE_FISHER_RTOL
          and np.all(np.isfinite(got.matrix)),
          "kde_example Fisher matrix: the card's is off the CPU's")
    check(kde == (2, 0, 2), f"kde_example Fisher (float64): KDE launches"
          f" {kde}")


def kde_live_share(ct, smi):
    """The live share of a stacked KDE template's slots and pairs: each
    channel's live count as utils/kde.py:KDEPlan.live_order gives it to the
    kernels (the PID cut and the stacking's padding), against the dense
    (categories x channels x padded events) layout. Returns the counts."""
    from pisa_tpu_torch.stages.utils.kde import kde

    stage = next(s for s in ct.pipeline.stages if isinstance(s, kde))
    sc = ct._trace_data.containers[0]
    rep = sc.representation
    sc.representation = "events"
    try:
        sample = stage._sample(sc)
    finally:
        sc.representation = rep
    plan = next(iter(stage._plans.values()))
    _, counts = plan.live_order(sample, sc.real_events)
    counts = counts.reshape(-1).tolist()
    n_pad = sc.n_pad
    slots = len(counts) * n_pad
    pairs = sum(n * n for n in counts)
    grid = plan.points.shape[1]
    print(f"kde_example's stacked KDE: {len(counts)} channels of {n_pad}"
          f" slots; live samples {sum(counts)} of {slots}"
          f" ({100 * sum(counts) / slots:.1f}%), pilot pairs {pairs} of"
          f" {len(counts) * n_pad ** 2} ({100 * pairs / (len(counts) * n_pad ** 2):.1f}%),"
          f" grid pairs {sum(counts) * grid} of {slots * grid}; channels"
          f" without a live sample {sum(n == 0 for n in counts)}; counts"
          f" {counts} [{smi}]")
    return counts


def kde_launches():
    from pisa_tpu_torch.ops import kde as ops_kde

    return (ops_kde.sum_launch_count, ops_kde.vjp_launch_count,
            ops_kde.jvp_launch_count)


def reset_kde_launches():
    from pisa_tpu_torch.ops import kde as ops_kde

    ops_kde.sum_launch_count = ops_kde.vjp_launch_count = 0
    ops_kde.jvp_launch_count = 0


def events_fp32(chain, smi):
    """kde_example.cfg at full width in float32: its loader fed
    make_toy_events(TOY_EVENTS, TOY_SEED) (240,000 events, 12 categories,
    the 200x200 calc grid). The eager template, the stacked captured
    template, the captured value_and_grad of mod_chi2 (wall, device time,
    kernels, busy share, peak memory, waits), a ``device`` fit through
    Analysis from theta23 moved by +0.10 rescaled on the Asimov data, its
    Fisher matrix (jacfwd of the eager template: wall and KDE launches);
    then example.cfg at the same events: template and value_and_grad.
    Returns the launches of the path: ((primal, tangent, multitangent),
    (KDE sum, KDE vjp, KDE jvp))."""
    import numpy as np
    import torch

    from pisa_tpu_torch.analysis.analysis import Analysis, BasicAnalysis
    from pisa_tpu_torch.core.distribution_maker import DistributionMaker
    from pisa_tpu_torch.core.pipeline import Pipeline

    total, total_kde = [0, 0, 0], [0, 0, 0]

    def reset():
        reset_launch_counts(chain)
        reset_kde_launches()

    def add():
        launches, kde = launch_counts(chain), kde_launches()
        for i, n in enumerate(launches):
            total[i] += n
        for i, n in enumerate(kde):
            total_kde[i] += n
        reset()
        return launches, kde

    from pisa_tpu_torch.scripts.make_toy_events import make_toy_events

    t0 = time.perf_counter()
    toy = make_toy_events(num_events=TOY_EVENTS, seed=TOY_SEED)
    make_s = time.perf_counter() - t0
    cfg = toy_config(KDE_CFG, toy)
    reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipeline = Pipeline(cfg, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_events = sum(len(cat["true_energy"]) for cat in
                   pipeline["data.simple_data_loader"].evts.values())
    t0 = time.perf_counter()
    maps = pipeline.get_outputs()
    first_s = time.perf_counter() - t0
    wall, _ = median_wall(pipeline.get_outputs, 3)
    launches, kde = add()
    totals = [float(m.hist.sum()) for m in maps]
    print(f"float32 kde_example, {n_events} toy events"
          f" (make_toy_events {make_s:.2f} s): Pipeline set-up {setup_s:.2f}"
          f" s, first template {first_s:.2f} s, then get_outputs median"
          f" {wall * 1e3:.2f} ms (3 runs, the KDE in each),"
          f" {sum(totals):.1f} expected events; launches (primal, tangent,"
          f" multitangent) {launches}, KDE (sum, vjp) {kde}; peak memory"
          f" {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB [{smi}]")
    check(n_events == 12 * TOY_EVENTS and all(np.isfinite(totals)),
          "kde_example at full width: template not finite")
    check(kde[0] > 0, "the eager KDE template launched no kde_gauss_sum")
    ct = pipeline.compile()
    check(ct.stacked, "kde_example's template is not stacked")
    t0 = time.perf_counter()
    stacked = ct.get_outputs(ct.current_rescaled_values())
    kde_live_share(ct, smi)
    capture_s = time.perf_counter() - t0
    rel = maps_rel(stacked, maps)
    cwall, _ = median_wall(lambda: ct.get_outputs(
        ct.current_rescaled_values()), 10)
    launches, kde = add()
    print(f"float32 kde_example, stacked captured template: {rel:.3e} of the"
          f" eager maps' largest bins (bound {TEMPLATE_RTOL['float32']:g});"
          f" capture with its first call {capture_s:.2f} s, then"
          f" {cwall * 1e3:.3f} ms a call with its read (median of 10);"
          f" launches at the capture {launches}, KDE {kde} [{smi}]")
    check(rel <= TEMPLATE_RTOL["float32"],
          "kde_example: the captured template is off the eager one")
    vg_launches = measure_vg("kde_example at 240k toy events", ct, chain,
                             smi)
    _, kde = add()
    print(f"kde_example value_and_grad: KDE launches (sum, vjp) of the eager"
          f" run, the warm-up and the capture {kde} [{smi}]")
    check(kde[0] > 0 and kde[1] > 0, "the KDE kernels did not run in the"
          " value_and_grad")
    check(vg_launches[0] > 0, "kde_example's value_and_grad launched no"
          " primal kernel")

    # the Fisher matrix: jacfwd of the eager template, the density's
    # tangents from kde_gauss_sum_jvp (all directions on its direction axis:
    # one launch at the samples and one at the points)
    from pisa_tpu_torch.analysis.fisher import get_fisher_matrix

    get_fisher_matrix(ct)  # the first call builds the cached tensors
    add()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fm = get_fisher_matrix(ct)
    wall = time.perf_counter() - t0
    launches, kde = add()
    n = len(fm.parameters)
    print(f"float32 Fisher matrix, kde_example at 240k toy events ({n}"
          f" params), jacfwd of the eager template: wall {wall * 1e3:.2f} ms"
          f" (second call); launches {launches}, KDE (sum, vjp, jvp) {kde}"
          f" (jvp: the pilot's and the points', each with the {n}"
          f" directions);"
          f" peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB;"
          f" diagonal {np.diag(fm.matrix).tolist()} [{smi}]")
    check(np.all(np.isfinite(fm.matrix)) and np.all(np.diag(fm.matrix) > 0),
          "kde_example Fisher matrix not finite or not positive")
    check(kde == (2, 0, 2), f"kde_example Fisher: KDE launches {kde}")
    del ct, pipeline
    torch.cuda.empty_cache()

    # the device fit through the analysis layer
    dm = DistributionMaker([cfg], device="cuda")
    data = dm.get_outputs(return_sum=True)
    truth = dm.params["theta23"]._rescaled_value
    add()

    def fit():
        dm.reset_free()
        dm.params["theta23"]._rescaled_value = min(0.95, truth + 0.10)
        return Analysis().fit_recursively(
            data, dm, "mod_chi2", None, "device",
            {"max_steps": KDE_FIT_STEPS}, None)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    waits, result = count_host_syncs(fit)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    meta = result.minimizer_metadata
    moved = result.params["theta23"]._rescaled_value - truth
    launches, kde = add()
    print(f"Analysis fit, kde_example at 240k toy events"
          f" ({len(dm.params.free)} free), device (max_steps"
          f" {KDE_FIT_STEPS}), float32: wall {wall:.3f} s"
          f" with the set-up and capture of its objective, nit {meta['nit']},"
          f" nfev {meta['nfev']}, {waits} waits for the card"
          f" ({waits / meta['nfev']:.2f} per evaluation), theta23 off the"
          f" truth by {moved:.3e} rescaled (bound {FIT_TOL:g}), metric"
          f" {result.metric_val!r}; launches {launches}, KDE {kde} [{smi}]")
    check(abs(moved) <= FIT_TOL, "the kde_example fit did not recover"
          " theta23")
    check(waits / meta["nfev"] <= DEVICE_FIT_WAITS,
          f"the kde_example fit waited {waits / meta['nfev']:.2f} times per"
          " evaluation")
    BasicAnalysis._compiled_cache.clear()
    del dm
    torch.cuda.empty_cache()

    # example.cfg (the histogram instead of the KDE) at the same events
    cfg = toy_config(EXAMPLE_CFG, toy)
    pipeline = Pipeline(cfg, device="cuda")
    maps = pipeline.get_outputs()
    wall, _ = median_wall(pipeline.get_outputs, 3)
    launches, _ = add()
    print(f"float32 example.cfg at 240k toy events: get_outputs median"
          f" {wall * 1e3:.2f} ms (3 runs), {sum(float(m.hist.sum()) for m in maps):.1f}"
          f" expected events; launches {launches} [{smi}]")
    ct = pipeline.compile()
    measure_vg("example.cfg at 240k toy events", ct, chain, smi)
    add()
    del ct, pipeline
    torch.cuda.empty_cache()
    print(f"events path launches (primal, tangent, multitangent):"
          f" {tuple(total)}, KDE (sum, vjp, jvp) {tuple(total_kde)} [{smi}]")
    check(all(n > 0 for n in total_kde), "a KDE kernel never ran on the"
          " events path")
    return tuple(total), tuple(total_kde)


def kde_checks(smi):
    """kde_vs_plain, then kde_jvp_vs_plain, with the wall of each; returns
    kde_vs_plain's lines with the jvp's under "kde_gauss_sum_jvp"."""
    t0 = time.perf_counter()
    kde_kernels = kde_vs_plain(smi)
    t1 = time.perf_counter()
    kde_kernels["kde_gauss_sum_jvp"] = kde_jvp_vs_plain(smi)
    t2 = time.perf_counter()
    print(f"KDE kernel checks: {t2 - t0:.1f} s (kde_vs_plain {t1 - t0:.1f}"
          f" s, kde_jvp_vs_plain {t2 - t1:.1f} s)")
    return kde_kernels


def events_only_main(chain, smi):
    """``--events-only``: the kernels built, the KDE kernels held and
    timed, then the events phases alone (the float64 children's and the
    main process's: the KDE and HDF5 phases, then the events-file
    workflow); no status line."""
    kde_checks(smi)
    with tempfile.TemporaryDirectory(prefix="events_file_fp64_") as events:
        run_children([("events", ["--events-worker"]),
                      ("events file", ["--events-file-worker", events])])
        t0 = time.perf_counter()
        launches = events_fp32(chain, smi)
        print(f"float32 events phase: {time.perf_counter() - t0:.1f} s;"
              f" launches {launches}")
        launches = events_file_fp32(chain, events, smi)
    print(f"events-file launches {launches}")
    return 0

# -- the events-file workflow: simulation -> make_events_file ->
# add_flux_to_events_file -> example.cfg, on the port's own HDF5 writer ------
def events_file_build(directory):
    """The workflow of testing/events_workflow.py at full width into
    `directory`: the per-run source files (EVENTS_FILE_PER_FLAVINT events
    for each of the 12 flavour and interaction categories, seeded), then
    make_events_file (unjoined, no cut) and add_fluxes_to_file (the Honda
    table, flux name "nominal"), each timed; the Events and the dict that
    add_fluxes_to_file wrote are kept as the scripts held them. Returns
    (paths, in memory, seconds)."""
    from pisa_tpu_torch.scripts import add_flux_to_events_file as add_flux
    from pisa_tpu_torch.scripts.make_events_file import make_events_file
    from pisa_tpu_torch.testing import events_workflow as W
    from pisa_tpu_torch.utils.flux_weights import load_2d_table

    seconds, held = {}, {}

    def timed(label, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            seconds[label] = time.perf_counter() - t0
            return out
        return run

    def keep(obj, fname, **kwargs):
        held["fluxes"] = obj
        return write(obj, fname, **kwargs)

    sources = timed("write sources", W.write_sources)(
        os.path.join(directory, "sources"), EVENTS_FILE_PER_FLAVINT,
        seed=EVENTS_FILE_SEED)
    write, add_flux.to_file = add_flux.to_file, keep
    try:
        held["events"], events_path, flux_path = W.make_example_events_file(
            timed("make_events_file", make_events_file),
            timed("add_fluxes_to_file", add_flux.add_fluxes_to_file),
            load_2d_table, sources, directory, EVENTS_FILE_PER_FLAVINT)
    finally:
        add_flux.to_file = write
    paths = {"sources": sources, "events": events_path, "fluxes": flux_path}
    return paths, held, seconds


def file_digest(path):
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def events_file_config(events_file, fine=False):
    """example.cfg reading `events_file`; with `fine`, histogrammed into
    EVENTS_FILE_FINE_BINS reco bins (past the one-hot budget of 512)."""
    from pisa_tpu_torch import ureg
    from pisa_tpu_torch.config.parser import parse_pipeline_config
    from pisa_tpu_torch.core import binning

    cfg = parse_pipeline_config(EXAMPLE_CFG)
    cfg[("data", "simple_data_loader")]["events_file"] = events_file
    if fine:
        e_bins, cz_bins = EVENTS_FILE_FINE_BINS
        reco = binning.MultiDimBinning([
            binning.OneDimBinning("reco_energy", num_bins=e_bins,
                                  is_log=True, domain=[5, 100] * ureg.GeV),
            binning.OneDimBinning("reco_coszen", num_bins=cz_bins,
                                  is_lin=True, domain=[-1, 1]),
            binning.OneDimBinning("pid", bin_edges=[-1000.0, 0.0, 1000.0]),
        ], name="fine_reco")
        cfg["pipeline"]["output_binning"] = reco
        cfg[("utils", "hist")]["apply_mode"] = reco
    return cfg


def events_file_worker(directory):
    """float64: the events-file workflow into `directory`, then example.cfg
    from the file with fluxes on the CPU (the reference of events_file_fp32)
    and on the card (held to the CPU within TEMPLATE_RTOL["float64"]);
    saves the CPU maps and errors and the file's digest to
    `directory`/fp64.npz."""
    import numpy as np

    from pisa_tpu_torch import FTYPE_NAME
    from pisa_tpu_torch.core.pipeline import Pipeline

    check(FTYPE_NAME == "fp64", f"events-file worker runs {FTYPE_NAME}")
    smi = card_line()
    t0 = time.perf_counter()
    paths, _, seconds = events_file_build(directory)
    cfg = events_file_config(paths["fluxes"])
    cpu = Pipeline(cfg, device="cpu").get_outputs()
    gpu = Pipeline(cfg, device="cuda").get_outputs()
    rel = maps_rel(gpu, cpu)
    print(f"float64 example.cfg from the written events file, card vs CPU:"
          f" worst bin {rel:.3e} of its map's largest (bound"
          f" {TEMPLATE_RTOL['float64']:g}); the workflow "
          + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items())
          + f" [{smi}]")
    check(rel <= TEMPLATE_RTOL["float64"],
          "example.cfg from the written file: the card's maps are off the"
          " CPU's")
    arrays = {"digest": np.array(file_digest(paths["fluxes"]))}
    for m in cpu:
        arrays[f"w|{m.name}"] = m.hist
        arrays[f"e|{m.name}"] = m.error_hist
    np.savez(os.path.join(directory, "fp64.npz"), **arrays)
    print(f"float64 events-file phase: {time.perf_counter() - t0:.1f} s"
          f" [{smi}]")


def same_arrays(got, want, path=""):
    """The nested dicts of arrays `got` (as read back) and `want` (as the
    scripts held them) hold the same keys and bit-equal arrays; returns the
    number of arrays compared."""
    import numpy as np

    check(sorted(got) == sorted(want), f"{path}: keys {sorted(got)} read"
          f" back, {sorted(want)} written")
    n = 0
    for key, value in want.items():
        if isinstance(value, dict):
            n += same_arrays(got[key], value, f"{path}/{key}")
            continue
        ref = np.asarray(value)
        back = got[key]
        if ref.dtype.kind in "UO":
            def text(x):
                return x.decode() if isinstance(x, bytes) else str(x)

            same = [text(b) for b in np.asarray(back).reshape(-1)] == [
                text(r) for r in ref.reshape(-1)]
        else:
            same = (back.dtype == ref.dtype and back.shape == ref.shape
                    and back.tobytes() == ref.tobytes())
        check(same, f"{path}/{key}: read back differs from what was"
              " written")
        n += 1
    return n


def events_file_fp32(chain, directory, smi):
    """The events-file workflow at full width on the card's machine, in
    float32: the per-run sources written with the port's HDF5 writer, the
    two scripts, the files read back bit-equal to what the scripts held
    (and byte-equal to the float64 child's, whose template of the same file
    is the reference), example.cfg from the file on the card (one template
    within EVENTS_FILE_RTOL of the float64 one in bins >= 1 event, one
    captured value_and_grad), and the laned scatter-added histogram
    (EVENTS_FILE_LANES lanes per container, past the one-hot budget)
    against as many unlaned calls. Returns the path's launches (primal,
    tangent, multitangent): of a laned check, its one timed laned
    evaluation's, not the unlaned reference's."""
    import numpy as np
    import torch

    from pisa_tpu_torch.core.events import Events
    from pisa_tpu_torch.core.pipeline import Pipeline
    from pisa_tpu_torch.utils.hdf import from_hdf
    from pisa_tpu_torch.utils.hdf5_reader import read_hdf5

    started = time.perf_counter()
    total = [0, 0, 0]

    def add():
        launches = launch_counts(chain)
        for i, n in enumerate(launches):
            total[i] += n
        reset_launch_counts(chain)
        return launches

    with np.load(os.path.join(directory, "fp64.npz")) as f:
        ref = {k: f[k] for k in f.files}
    tmp = tempfile.mkdtemp(prefix="events_file_")
    try:
        paths, held, seconds = events_file_build(tmp)
        t0 = time.perf_counter()
        sources = {path: read_hdf5(path) for run in paths["sources"].values()
                   for path in run}
        seconds["read sources"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        events = from_hdf(paths["events"])
        seconds["read events file"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fluxes = from_hdf(paths["fluxes"])
        seconds["read file with fluxes"] = time.perf_counter() - t0
        n_events = sum(v["true_energy"].size for k, v in fluxes.items()
                       if k != "metadata")
        size = sum(os.path.getsize(p) for p in
                   [paths["events"], paths["fluxes"], *sources])
        check("h5py" not in [m for m, v in sys.modules.items()
                             if v is not None], "h5py was imported")
        evts = held["events"]
        written = {str(fi): evts[fi] for fi in evts.flavints_present}
        written["metadata"] = evts.metadata
        n = same_arrays(events, written, "events file")
        n += same_arrays(fluxes, held["fluxes"], "file with fluxes")
        digest = file_digest(paths["fluxes"])
        print(f"events-file workflow, {n_events} events in"
              f" {len(sources)} source files ({size / 2**20:.1f} MiB with the"
              f" two events files), no h5py: "
              + ", ".join(f"{k} {v:.3f} s" for k, v in seconds.items())
              + f"; {n} arrays read back bit-equal to the scripts'; the file"
              f" with fluxes byte-equal to the float64 child's:"
              f" {digest == str(ref['digest'])} [{smi}]")
        check(n_events == 12 * EVENTS_FILE_PER_FLAVINT,
              f"the events file holds {n_events} events")
        check(digest == str(ref["digest"]), "the float64 child wrote another"
              " events file")
        check(len(Events(paths["fluxes"]).flavints_present) == 12,
              "Events does not read the written file")

        # example.cfg from the file: the template against float64, then the
        # captured value_and_grad
        reset_launch_counts(chain)
        t0 = time.perf_counter()
        pipeline = Pipeline(events_file_config(paths["fluxes"]),
                            device="cuda")
        maps = pipeline.get_outputs()
        torch.cuda.synchronize()
        template_s = time.perf_counter() - t0
        template_launches = add()
        worst_w = worst_e = 0.0
        # every bin >= 1 event: (relative error, channel, map, flat bin,
        # float64 value)
        bins = []
        for m in maps:
            want = ref[f"w|{m.name}"]
            mask = np.abs(want) >= MIN_EVENTS_FP32
            worst_w = max(worst_w, max_rel(want, m.hist, mask))
            worst_e = max(worst_e, max_rel(ref[f"e|{m.name}"], m.error_hist,
                                           mask))
            for channel, want_c, got_c in (
                    ("weights", want, m.hist),
                    ("errors", ref[f"e|{m.name}"], m.error_hist)):
                want_c = np.asarray(want_c, dtype=np.float64).ravel()
                got_c = np.asarray(got_c, dtype=np.float64).ravel()
                for i in np.flatnonzero(mask.ravel()):
                    bins.append((abs(got_c[i] - want_c[i]) / abs(want_c[i]),
                                 channel, m.name, int(i), want_c[i],
                                 want.ravel()[i]))
        for channel in ("errors", "weights"):
            worst = sorted((b for b in bins if b[1] == channel),
                           reverse=True)[:3]
            print(f"float32 example.cfg from the written file, the three"
                  f" {channel} bins farthest from float64: " + "; ".join(
                      f"{name} bin {i}: {err:.3e} of {value:.6g}"
                      f" ({events:.6g} expected events)"
                      for err, _, name, i, value, events in worst)
                  + f" [{smi}]")
        # whether the float32 sums carry that margin: the same float32
        # event weights, histogrammed in float64 (the errors the root of
        # the float64 sum of their squares)
        reco = pipeline["utils.hist"].apply_mode
        summed64 = {"weights": 0.0, "errors": 0.0}
        for c in pipeline.data.containers:
            prev, c.representation = c.representation, "events"
            w = c["weights"].double()
            idx = c.cached_flat_indices(reco)
            c.representation = prev
            want = ref[f"w|{c.name}"].ravel()
            mask = np.abs(want) >= MIN_EVENTS_FP32
            for channel, values, ref_c in (
                    ("weights", w, want),
                    ("errors", torch.square(w), ref[f"e|{c.name}"].ravel())):
                h = torch.zeros(reco.size + 1, dtype=torch.float64,
                                device=w.device).index_add_(0, idx, values)
                h = h[:reco.size].cpu().numpy()
                if channel == "errors":
                    h = np.sqrt(h)
                summed64[channel] = max(summed64[channel],
                                        max_rel(ref_c, h, mask))
        print(f"float32 example.cfg from the written file, its float32 event"
              f" weights histogrammed in float64 vs the float64 template"
              f" (bins >= 1 event): weights {summed64['weights']:.3e}, errors"
              f" {summed64['errors']:.3e} [{smi}]")
        expected = sum(float(m.hist.sum()) for m in maps)
        print(f"float32 example.cfg from the written file: set-up and first"
              f" template {template_s:.2f} s, {expected:.1f} expected events;"
              f" vs the float64 template of the same file (bins >= 1 event):"
              f" weights {worst_w:.3e}, errors {worst_e:.3e} (bound"
              f" {EVENTS_FILE_RTOL:g}); launches (primal, tangent,"
              f" multitangent) {template_launches} [{smi}]")
        check(worst_w <= EVENTS_FILE_RTOL and worst_e <= EVENTS_FILE_RTOL,
              "example.cfg from the written file: the float32 template is"
              " off the float64 one")
        ct = pipeline.compile()
        vg_launches = measure_vg("example.cfg from the written events file",
                                 ct, chain, smi)
        add()
        print(f"example.cfg from the written file: launches (primal, tangent,"
              f" multitangent) of one template {template_launches}, of one"
              f" eager value_and_grad {vg_launches} [{smi}]")
        check(template_launches[0] > 0 and vg_launches[2] > 0,
              "example.cfg from the written file ran no chain kernel")
        del ct, pipeline
        torch.cuda.empty_cache()

        # the laned scatter-added histogram, per container, past the
        # one-hot budget, against one unlaned evaluation per lane
        ct = Pipeline(events_file_config(paths["fluxes"], fine=True),
                      device="cuda").compile(stack=False)
        check(ct.output_binning.size > 512 and not ct.stacked,
              "the fine example.cfg is not a per-container scatter")
        rng = np.random.RandomState(EVENTS_FILE_SEED)
        x0 = ct.current_rescaled_values()
        vecs = np.clip(x0 + rng.uniform(-0.05, 0.05,
                                        (EVENTS_FILE_LANES, x0.size)), 0, 1)
        with torch.no_grad():
            laned = ct._evaluate(ct._magnitudes_from_rescaled(
                torch.as_tensor(vecs, device="cuda")),
                lanes=EVENTS_FILE_LANES)
            torch.cuda.synchronize()
            # the path's launches: the one laned evaluation's
            reset_launch_counts(chain)
            t0 = time.perf_counter()
            laned = ct._evaluate(ct._magnitudes_from_rescaled(
                torch.as_tensor(vecs, device="cuda")),
                lanes=EVENTS_FILE_LANES)
            torch.cuda.synchronize()
            laned_ms = (time.perf_counter() - t0) * 1e3
            launches = add()
            t0 = time.perf_counter()
            single = [ct._evaluate(ct._magnitudes_from_rescaled(
                torch.as_tensor(v, device="cuda"))) for v in vecs]
            torch.cuda.synchronize()
            single_ms = (time.perf_counter() - t0) * 1e3
            # the unlaned reference's launches are not the path's
            reset_launch_counts(chain)
        worst = 0.0
        for name, hist in laned["hist"].items():
            for lane in range(EVENTS_FILE_LANES):
                want = single[lane]["hist"][name].double().cpu().numpy()
                got = hist[lane].double().cpu().numpy()
                worst = max(worst, float(np.abs(got - want).max()
                                         / np.abs(want).max()))
        spread = float(np.abs(
            laned["hist"]["numu_cc"][0].double().cpu().numpy()
            - laned["hist"]["numu_cc"][-1].double().cpu().numpy()).max())
        print(f"float32 laned scatter-added histogram: example.cfg into"
              f" {ct.output_binning.size} bins per container,"
              f" {EVENTS_FILE_LANES} lanes at {n_events} events: each lane vs"
              f" its unlaned evaluation {worst:.3e} of the largest bin"
              f" (bound {EVENTS_FILE_LANES_ATOL:g}); laned evaluation"
              f" {laned_ms:.2f} ms, {EVENTS_FILE_LANES} unlaned"
              f" {single_ms:.2f} ms; launches of the laned evaluation"
              f" {launches} [{smi}]")
        check(worst <= EVENTS_FILE_LANES_ATOL and spread > 0,
              "the laned scatter-added histogram is off the unlaned calls")
        del ct
        torch.cuda.empty_cache()
        events_file_resampling(chain, add, smi)
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - started
    print(f"float32 events-file phase: {wall:.1f} s (budget"
          f" {EVENTS_FILE_BUDGET_S} s); launches (primal, tangent,"
          f" multitangent) {tuple(total)} [{smi}]")
    return tuple(total)


def resampled_toy_config():
    """toy_fit_example.cfg with prob3 computed on a RESAMPLE_GRID_BINS^2
    grid and applied on its calc_grid_coarse, so that its probabilities
    are resampled between the two binnings (tests/test_torch_hist_lanes.py
    cuts the grid to 20 x 20)."""
    from pisa_tpu_torch import ureg
    from pisa_tpu_torch.config.parser import parse_pipeline_config
    from pisa_tpu_torch.core import binning

    cfg = parse_pipeline_config("settings/pipeline/toy_fit_example.cfg")
    cfg[("osc", "prob3")]["calc_mode"] = binning.MultiDimBinning([
        binning.OneDimBinning("true_energy", num_bins=RESAMPLE_GRID_BINS,
                              is_log=True, domain=[1, 1000] * ureg.GeV),
        binning.OneDimBinning("true_coszen", num_bins=RESAMPLE_GRID_BINS,
                              is_lin=True, domain=[-1, 1]),
    ], name="osc_grid")
    return cfg


def events_file_resampling(chain, add, smi):
    """Laned map-to-map resampling on the card: toy_fit_example's
    probabilities resampled from a 200 x 200 grid onto its calc grid with
    EVENTS_FILE_LANES lanes folded into the channels
    (``core/container.py:translate``), each lane against its unlaned
    evaluation, within RESAMPLE_LANES_ATOL of the lane's largest bin; the
    resampling ran with the lane axis. `add` takes the launches of the one
    timed laned evaluation."""
    import numpy as np
    import torch

    from pisa_tpu_torch.core import translation
    from pisa_tpu_torch.core.pipeline import Pipeline

    ct = Pipeline(resampled_toy_config(), device="cuda").compile(stack=False)
    rng = np.random.RandomState(EVENTS_FILE_SEED)
    x0 = ct.current_rescaled_values()
    vecs = np.clip(x0 + rng.uniform(-0.05, 0.05,
                                    (EVENTS_FILE_LANES, x0.size)), 0, 1)
    shapes = []
    resample = translation.resample

    def counted(values, *args, **kwargs):
        shapes.append(tuple(values.shape))
        return resample(values, *args, **kwargs)

    translation.resample = counted
    try:
        with torch.no_grad():
            vec = torch.as_tensor(vecs, device="cuda")
            ct._evaluate(ct._magnitudes_from_rescaled(vec),
                         lanes=EVENTS_FILE_LANES)
            torch.cuda.synchronize()
            # the path's launches: the one laned evaluation's
            reset_launch_counts(chain)
            t0 = time.perf_counter()
            laned = ct._evaluate(ct._magnitudes_from_rescaled(vec),
                                 lanes=EVENTS_FILE_LANES)
            torch.cuda.synchronize()
            laned_ms = (time.perf_counter() - t0) * 1e3
            launches = add()
            laned_shapes = list(shapes)
            t0 = time.perf_counter()
            single = [ct._evaluate(ct._magnitudes_from_rescaled(
                torch.as_tensor(v, device="cuda"))) for v in vecs]
            torch.cuda.synchronize()
            single_ms = (time.perf_counter() - t0) * 1e3
            # the unlaned reference's launches are not the path's
            reset_launch_counts(chain)
    finally:
        translation.resample = resample
    worst = 0.0
    for name, hist in laned["hist"].items():
        for lane in range(EVENTS_FILE_LANES):
            want = single[lane]["hist"][name].double().cpu().numpy()
            got = hist[lane].double().cpu().numpy()
            worst = max(worst, float(np.abs(got - want).max()
                                     / np.abs(want).max()))
    spread = float(np.abs(
        laned["hist"]["numu_cc"][0].double().cpu().numpy()
        - laned["hist"]["numu_cc"][-1].double().cpu().numpy()).max())
    # the laned evaluations' resamplings fold the lanes into the channels:
    # (points, channels x lanes)
    folded = [s for s in laned_shapes if len(s) == 2
              and s[1] % EVENTS_FILE_LANES == 0]
    print(f"float32 laned map-to-map resampling: toy_fit_example's"
          f" probabilities from a {RESAMPLE_GRID_BINS}x{RESAMPLE_GRID_BINS}"
          f" grid onto {ct.output_binning.size} bins per container,"
          f" {EVENTS_FILE_LANES} lanes: each lane vs its unlaned evaluation"
          f" {worst:.3e} of the largest bin (bound {RESAMPLE_LANES_ATOL:g});"
          f" {len(folded)} resamplings with the lanes folded into the"
          f" channels, e.g. {folded[:1]}; laned evaluation {laned_ms:.2f} ms,"
          f" {EVENTS_FILE_LANES} unlaned {single_ms:.2f} ms; launches of the"
          f" laned evaluation {launches} [{smi}]")
    check(worst <= RESAMPLE_LANES_ATOL and spread > 0 and folded,
          "the laned resampling is off the unlaned calls")
    check(launches[0] > 0, f"the laned resampling's launches {launches}")
    del ct
    torch.cuda.empty_cache()


# -- hypersurfaces: fit on the flagship, then apply ---------------------------
def hs_fit_config(pipeline_cfg=CFG):
    """The fit configuration of scripts/fit_hypersurfaces.py (and of the
    interpolated workflow) for HS_PARAMS on the config file `pipeline_cfg`:
    13 datasets (HS_NOMINAL and HS_POINTS), the maps combined into
    HS_GROUPS."""
    return {"pipeline_cfg": pipeline_cfg, "params": dict(HS_PARAMS),
            "nominal_dataset": {"param_values": dict(HS_NOMINAL)},
            "sys_datasets": [{"param_values": dict(p)}
                             for p in [HS_NOMINAL] + HS_POINTS],
            "combine_regex": list(HS_GROUPS), "norm": True}


def hs_group_names(surfaces):
    """`surfaces` keyed by the link groups' names (a fit of combined maps is
    keyed by the regexes)."""
    return {HS_GROUPS.get(k, k): v for k, v in surfaces.items()}


def hs_rename_file(path):
    """The assembled interpolated fits at `path`, keyed by the link groups'
    names, written back."""
    from pisa_tpu_torch.utils.jsons import from_json, to_json

    to_json(hs_group_names(from_json(path)), path)


def hs_datasets(pipeline):
    """(nominal MapSet, the HS_POINTS MapSets) of `pipeline`, combined into
    HS_GROUPS, as fit_hypersurfaces_from_pipeline makes them; the params
    are left at HS_NOMINAL."""
    def at(values):
        for name, value in values.items():
            prm = pipeline.params[name]
            prm.value = value * prm.value.units
        return pipeline.get_outputs().combine_re(list(HS_GROUPS))

    systematic = [at(p) for p in HS_POINTS]
    return at(HS_NOMINAL), systematic


def hs_fit_maps(nominal, systematic, binning, device):
    """fit_hypersurfaces_from_maps over the 13 datasets, as bench.py:700-704
    calls it."""
    from pisa_tpu_torch.utils import hypersurface as hs

    return hs.fit_hypersurfaces_from_maps(
        nominal_mapset=nominal, nominal_param_values=HS_NOMINAL,
        sys_mapsets=systematic, sys_param_values=HS_POINTS, binning=binning,
        params=HS_PARAMS, include_nominal=True, device=device)


def hs_config(path=None, interpolated=False, csv_paths=None, base=CFG):
    """The flagship config (`base`) with its hypersurfaces stage on the
    fitted JSON `path` (uncertainty propagated into 'errors'), or with
    `interpolated` on the assembled interpolated fits at `path` (deltam31
    fixed at HS_DM31_POINT), or with `csv_paths` replaced by
    discr_sys.csv_hypersurfaces over deltam31 (free); the stage's params are
    the upstream stages' HS_PARAMS (and deltam31), shared with them."""
    from pisa_tpu_torch import ureg
    from pisa_tpu_torch.config.parser import parse_pipeline_config
    from pisa_tpu_torch.core.param import ParamSet

    cfg = parse_pipeline_config(base)
    key = ("discr_sys", "hypersurfaces")

    def find(name, selector=None):
        for k, settings in cfg.items():
            if isinstance(k, tuple) and k != key:
                try:
                    return settings["params"].get(name, selector)
                except (KeyError, AttributeError):
                    pass
        raise KeyError(name)

    params = [find(name) for name in HS_PARAMS]
    dm31 = find("deltam31", "nh")
    section = cfg[key]
    if csv_paths is not None:
        del cfg[key]
        cfg[("discr_sys", "csv_hypersurfaces")] = {
            "calc_mode": section["calc_mode"],
            "apply_mode": section["apply_mode"], "error_method": "sumw2",
            "links": section["links"],
            "fit_results_file": ",".join(csv_paths),
            "nominal_systematics": dict(HS_NOMINAL),
            "inter_param": "deltam31", "params": ParamSet(params + [dm31])}
        return cfg
    section.update(fit_results_file=path, propagate_uncertainty=True,
                   error_method="sumw2", interpolated=interpolated)
    if interpolated:
        dm31.value = HS_DM31_POINT * ureg.eV**2
        dm31.is_fixed = True
        params.append(dm31)
    section["params"] = ParamSet(params)
    return cfg


def hs_write_csv(path, directory):
    """csv_hypersurfaces files (one per link group, ``hs_<group>.csv``) from
    the assembled interpolated fits at `path`: at each deltam31 grid value
    the intercept, its sigma and each param's linear coefficient."""
    import numpy as np

    from pisa_tpu_torch.utils.hypersurface import Hypersurface
    from pisa_tpu_torch.utils.jsons import from_json

    paths = []
    for group, state in from_json(path).items():
        values = state["interp_param_spec"]["deltam31"]["values"]
        rows = []
        for value, fit in zip(values, state["hs_fits"]):
            surface = Hypersurface.from_state(fit)
            theta = surface._packed_theta()
            _, blocks = surface._unpack(theta)
            rows.append(np.column_stack(
                [theta[:, 0], np.sqrt(surface.fit_cov_mat[:, 0, 0])]
                + [blocks[name][:, 0] for name in HS_PARAMS]
                + [np.full(len(theta), value)]))
        paths.append(os.path.join(directory, f"hs_{group}.csv"))
        np.savetxt(paths[-1], np.concatenate(rows), delimiter=",",
                   comments="", header=",".join(
                       ["intercept", "intercept_sigma", *HS_PARAMS,
                        "deltam31"]))
    return paths


def hs_mismatch(got, want):
    """(worst coefficient difference relative to its bin's largest
    coefficient (the intercept, ~1), worst elementwise relative coefficient
    difference, worst covariance difference relative to its bin's largest
    entry) over the valid bins of every map, and whether the valid bins and
    the NaNs agree."""
    import numpy as np

    worst = [0.0, 0.0, 0.0]
    same = True
    for name, w in want.items():
        g = got[name]
        valid = w.fit_valid
        wt, gt = w._packed_theta(), g._packed_theta()
        same &= bool(np.array_equal(valid, g.fit_valid)
                     and np.array_equal(np.isnan(wt), np.isnan(gt)))
        wt, gt = wt[valid], gt[valid]
        diff = np.abs(gt - wt)
        worst[0] = max(worst[0], float(np.max(
            diff / np.abs(wt).max(axis=1, keepdims=True))))
        worst[1] = max(worst[1], float(np.max(diff / np.abs(wt))))
        wc, gc = w.fit_cov_mat[valid], g.fit_cov_mat[valid]
        worst[2] = max(worst[2], float(np.max(
            np.abs(gc - wc) / np.abs(wc).max(axis=(1, 2), keepdims=True))))
    return (*worst, same)


def hs_maps_rel(got, want):
    """maps_rel over the maps and their errors."""
    import numpy as np

    worst = maps_rel(got, want)
    for m in want:
        ref = np.asarray(m.error_hist)
        worst = max(worst, float(np.abs(got[m.name].error_hist - ref).max()
                                 / np.abs(ref).max()))
    return worst


def hypersurfaces_worker():
    """float64 (``--hypersurfaces-worker``), card against CPU: the fit of
    the flagship's 13 datasets at full width (made on the card; the CPU's
    templates are the reference child's) on both; the applied flagship (the
    CPU's fit as JSON, uncertainty propagated): maps with errors and the
    compiled value_and_grad; the interpolated workflow at
    HS_FP64_FRACTION of the events (prepare, a job, the resume, assemble)
    on each device, and the interpolated template at HS_DM31_POINT. Torch
    runs HS_FP64_THREADS CPU threads here: this child's CPU work runs
    beside the other children's."""
    import shutil

    import numpy as np
    import torch

    from pisa_tpu_torch import FTYPE_NAME
    from pisa_tpu_torch.core.pipeline import Pipeline
    from pisa_tpu_torch.utils import hypersurface as hs
    from pisa_tpu_torch.utils.resources import find_resource

    check(FTYPE_NAME == "fp64", f"hypersurfaces worker runs {FTYPE_NAME}")
    torch.set_num_threads(HS_FP64_THREADS)
    smi = card_line()
    started = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="hypersurfaces_fp64_")
    try:
        pipeline = Pipeline(CFG, device="cuda")
        datasets = hs_datasets(pipeline)
        binning = pipeline.output_binning
        del pipeline
        fits = {device: hs_fit_maps(*datasets, binning, device)
                for device in ("cpu", "cuda")}
        same = hs_mismatch(fits["cuda"], fits["cpu"])
        n_valid = sum(int(s.fit_valid.sum()) for s in fits["cpu"].values())
        print(f"float64 fit of the flagship's 13 datasets (made on the card,"
              f" combined into 4 groups), card vs CPU: coefficients"
              f" {same[0]:.3e} of their bin's largest ({same[1]:.3e}"
              f" elementwise; bound {HS_COEFF_FP64:g}), covariances"
              f" {same[2]:.3e} of their bin's largest (bound"
              f" {HS_COV_FP64:g}), valid bins and NaNs equal: {same[3]}"
              f" ({n_valid} valid bins) [{smi}]")
        check(same[3] and same[0] <= HS_COEFF_FP64
              and same[2] <= HS_COV_FP64,
              "the card's float64 fit is off the CPU's")

        path = os.path.join(tmp, "hypersurfaces.json")
        hs.save_hypersurfaces(hs_group_names(fits["cpu"]), path)
        cpu = Pipeline(hs_config(path), device="cpu")
        gpu = Pipeline(hs_config(path), device="cuda")
        rel = hs_maps_rel(gpu.get_outputs(), cpu.get_outputs())
        print(f"float64 flagship with the fitted hypersurfaces (uncertainty"
              f" propagated), card vs CPU: worst bin {rel:.3e} of its map's"
              f" largest, errors included (bound {HS_MAPS_FP64:g}) [{smi}]")
        check(rel <= HS_MAPS_FP64,
              "the applied hypersurfaces' maps are off the CPU's")
        vg_card_vs_cpu("flagship with the fitted hypersurfaces", cpu, gpu,
                       smi)
        del cpu, gpu

        with open(find_resource(CFG)) as f:
            text = f.read()
        small = os.path.join(tmp, "flagship_fraction.cfg")
        with open(small, "w") as f:
            f.write(text.replace(
                "[data.csv_loader]\n", "[data.csv_loader]\n"
                f"fraction_events_to_keep = {HS_FP64_FRACTION}\n", 1))
        spec = {"deltam31": {"values": HS_DM31, "scales_log": False}}
        maps = {}
        for device in ("cpu", "cuda"):
            fit_dir = os.path.join(tmp, f"interpolated_{device}")
            n_jobs = hs.prepare_interpolated_fit(fit_dir, spec,
                                                 hs_fit_config(small))
            hs.run_interpolated_fit(fit_dir, 0, device=device)
            for job in range(n_jobs):
                hs.run_interpolated_fit(fit_dir, job, skip_successful=True,
                                        device=device)
            check(hs.get_incomplete_job_idx(fit_dir) == [],
                  "interpolated jobs left")
            out = os.path.join(tmp, f"interpolated_{device}.json.bz2")
            hs.assemble_interpolated_fits(fit_dir, out)
            hs_rename_file(out)
            maps[device] = Pipeline(hs_config(out, interpolated=True,
                                              base=small),
                                    device=device).get_outputs()
        rel = hs_maps_rel(maps["cuda"], maps["cpu"])
        print(f"float64 interpolated workflow ({HS_FP64_FRACTION:g} of the"
              f" events; prepare, one job, the resume, assemble, each"
              f" device's own), the template at deltam31 = {HS_DM31_POINT:g}"
              f" eV^2, card vs CPU: worst bin {rel:.3e} of its map's"
              f" largest, errors included (bound {HS_MAPS_FP64:g}) [{smi}]")
        check(rel <= HS_MAPS_FP64,
              "the interpolated template is off the CPU's")
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"float64 hypersurfaces phase: {time.perf_counter() - started:.1f}"
          f" s [{smi}]")


def hypersurfaces_fp32(chain, pipeline, smi):
    """Float32 at full width: fit_hypersurfaces_from_pipeline on the
    flagship (HS_PARAMS, 13 datasets, the maps combined into HS_GROUPS);
    the fit alone, warm, as bench.py:697-704 times it, with its kernels and
    waits (none inside the Gauss-Newton loop) and its float32 coefficients
    against a float64 fit of the same inputs; the fit saved as JSON and
    applied with its uncertainty propagated: the eager and the stacked
    captured template, the captured value_and_grad (measure_vg) and a
    ``device`` fit through Analysis from theta23 + 0.10; the interpolated
    workflow over HS_DM31 (prepare, one job, the resume, assemble) and its
    template at HS_DM31_POINT, eager and captured; csv_hypersurfaces from
    the grid's fits with deltam31 free in a captured value_and_grad.
    `pipeline` is the float32 flagship on the card. Returns the path's
    (primal, tangent, multitangent) launches."""
    import shutil

    import numpy as np
    import torch

    from pisa_tpu_torch.analysis.analysis import Analysis, BasicAnalysis
    from pisa_tpu_torch.core.distribution_maker import DistributionMaker
    from pisa_tpu_torch.core.pipeline import Pipeline
    from pisa_tpu_torch.scripts.fit_hypersurfaces import (
        fit_hypersurfaces_from_pipeline,
    )
    from pisa_tpu_torch.utils import hypersurface as hs

    total = [0, 0, 0]

    def add():
        launches = launch_counts(chain)
        for i, n in enumerate(launches):
            total[i] += n
        reset_launch_counts(chain)
        return launches

    reset_launch_counts(chain)
    tmp = tempfile.mkdtemp(prefix="hypersurfaces_fp32_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        surfaces = fit_hypersurfaces_from_pipeline(
            pipeline_cfg=CFG, params=HS_PARAMS,
            nominal_param_values=HS_NOMINAL,
            sys_param_values=[HS_NOMINAL] + HS_POINTS,
            combine_regex=list(HS_GROUPS), device="cuda")
        entry_s = time.perf_counter() - t0
        launches = add()
        n_valid = sum(int(s.fit_valid.sum()) for s in surfaces.values())
        print(f"float32 fit_hypersurfaces_from_pipeline on the flagship"
              f" (Pipeline set-up, 13 datasets, the fit of {n_valid} valid"
              f" bins of {sum(s.binning.size for s in surfaces.values())}):"
              f" {entry_s:.2f} s; launches {launches} [{smi}]")
        check(n_valid > 0 and all(
            np.isfinite(s._packed_theta()[s.fit_valid]).all()
            for s in surfaces.values()), "the flagship fit is not finite")

        # the fit alone, warm, as bench.py times it, on the datasets of
        # `pipeline` at its nominal values
        pipeline.params.reset_all()
        nominal, systematic = hs_datasets(pipeline)
        datasets_launches = add()
        binning = pipeline.output_binning
        hs_fit_maps(nominal, systematic, binning, "cuda")  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fits = hs_fit_maps(nominal, systematic, binning, "cuda")
        wall = time.perf_counter() - t0
        median, least = median_wall(
            lambda: hs_fit_maps(nominal, systematic, binning, "cuda"), 5)
        same = hs_mismatch(fits, surfaces)
        fit_waits, _ = count_host_syncs(
            lambda: hs_fit_maps(nominal, systematic, binning, "cuda"))
        _, fit_device_ms, top, _, fit_kernels = profile_device_busy(
            lambda: hs_fit_maps(nominal, systematic, binning, "cuda"))
        groups, preps, _, y_all, w_all = hs.prepare_fit_from_maps(
            nominal, HS_NOMINAL, systematic, HS_POINTS, binning, HS_PARAMS)
        fitter = groups[0]._fitter()
        inputs = hs._fit_inputs(preps[0], "cuda", y_all, w_all)
        torch.cuda.synchronize()
        loop_waits, _ = count_host_syncs(lambda: fitter(*inputs))
        _, loop_device_ms, _, _, loop_kernels = profile_device_busy(
            lambda: fitter(*inputs))
        loop_ms = cuda_time(lambda: fitter(*inputs), 5)
        print(f"float32 hypersurface fit alone (bench.py's"
              f" hypersurface_fit_wall_s: 13 datasets, {y_all.shape[1]}"
              f" bins, warm): {wall:.4f} s, median of 5 {median:.4f} s (min"
              f" {least:.4f}); {fit_kernels} kernels and copies on the card"
              f" ({fit_device_ms:.3f} ms of device time), {fit_waits}"
              f" wait(s) for the card in a fit; the Gauss-Newton loop"
              f" (30 steps and the covariance, inputs on the card):"
              f" {loop_kernels} kernels, {loop_device_ms:.3f} ms of device"
              f" time, {loop_ms:.3f} ms back to back, {loop_waits} waits;"
              f" against the entry point's fit of its own Pipeline's"
              f" datasets: {same[0]:.3e} of a bin's largest coefficient"
              f" [{smi}]")
        for key, ms, count in top[:5]:
            print(f"  {ms:8.3f} ms  {count:5d}x  {key[:80]}")
        check(loop_waits == 0, f"the Gauss-Newton loop waited {loop_waits}"
              " times for the card")
        check(same[0] <= HS_COEFF_FP32 and same[3],
              "the fit of the same datasets differs from the entry point's")
        theta32, _ = fitter(*inputs)
        theta64, _ = fitter(inputs[0].double(), inputs[1].double(),
                            inputs[2].double(),
                            tuple(s.double() for s in inputs[3]))
        valid = np.concatenate([p["valid"] for p in preps])
        t32 = theta32.double().cpu().numpy()[valid]
        t64 = theta64.cpu().numpy()[valid]
        diff = np.abs(t32 - t64)
        gap = float(np.max(diff / np.abs(t64).max(axis=1, keepdims=True)))
        elementwise = float(np.max(diff / np.abs(t64)))
        print(f"float32 fit against a float64 fit of the same float32 inputs"
              f" on the card: {gap:.3e} of their bin's largest coefficient"
              f" ({elementwise:.3e} elementwise; bound {HS_COEFF_FP32:g})"
              f" over {int(valid.sum())} valid bins [{smi}]")
        check(gap <= HS_COEFF_FP32, "the float32 fit is off the float64 one")
        add()

        # the fit as JSON, applied with its uncertainty
        path = os.path.join(tmp, "hypersurfaces.json")
        hs.save_hypersurfaces(hs_group_names(surfaces), path)
        cfg = hs_config(path)
        applied = Pipeline(cfg, device="cuda")
        t0 = time.perf_counter()
        maps = applied.get_outputs()
        eager_s = time.perf_counter() - t0
        launches = add()
        totals = [float(m.hist.sum()) for m in maps]
        check(all(np.isfinite(m.hist).all() and np.isfinite(
            m.error_hist).all() for m in maps),
            "the applied template is not finite")
        ct = applied.compile()
        check(ct.stacked, "the applied template is not stacked")
        rel = maps_rel(ct.get_outputs(ct.current_rescaled_values()), maps)
        launches_c = add()
        print(f"float32 flagship with the fitted hypersurfaces (uncertainty"
              f" propagated): eager template {eager_s * 1e3:.1f} ms,"
              f" {sum(totals):.1f} expected events, launches {launches};"
              f" stacked captured template {rel:.3e} of the eager maps'"
              f" largest bins (bound {TEMPLATE_RTOL['float32']:g}), launches"
              f" at its capture {launches_c} [{smi}]")
        check(rel <= TEMPLATE_RTOL["float32"],
              "the applied captured template is off the eager one")
        vg_launches = measure_vg("flagship with the fitted hypersurfaces",
                                 ct, chain, smi)
        check(vg_launches == expected_vg_launches(True),
              f"the applied value_and_grad launched {vg_launches}")
        add()
        del ct, applied
        torch.cuda.empty_cache()

        dm = DistributionMaker([cfg], device="cuda")
        data = dm.get_outputs(return_sum=True)
        truth = dm.params["theta23"]._rescaled_value
        add()

        def fit():
            dm.reset_free()
            dm.params["theta23"]._rescaled_value = min(0.95, truth + 0.10)
            return Analysis().fit_recursively(
                data, dm, "mod_chi2", None, "device",
                {"max_steps": HS_FIT_STEPS}, None)

        # the first fit sets up and captures its objective, the second
        # reuses it (Analysis._compiled_cache): its waits are the loop's
        walls, waits, sources = [], [], {}
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n, result = count_host_syncs(fit, sources if not walls else None)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            waits.append(n)
            meta = result.minimizer_metadata
            moved = result.params["theta23"]._rescaled_value - truth
            launches = add()
            which = ("first: wall with the set-up and capture of its"
                     " objective" if len(walls) == 1 else "again: wall")
            print(f"Analysis fit, flagship with the fitted hypersurfaces"
                  f" ({len(dm.params.free)} free), device (max_steps"
                  f" {HS_FIT_STEPS}), float32, {which} {walls[-1]:.3f} s,"
                  f" nit {meta['nit']}, nfev {meta['nfev']}, {n} waits for"
                  f" the card ({n / meta['nfev']:.2f} per evaluation), theta23"
                  f" off the truth by {moved:.3e} rescaled (bound"
                  f" {FIT_TOL:g}), metric {result.metric_val!r}; launches"
                  f" {launches} [{smi}]")
            check(abs(moved) <= FIT_TOL, "the applied fit did not recover"
                  " theta23")
        print("  the first fit's waits by source line:")
        for where, count in sorted(sources.items(), key=lambda x: -x[1])[:8]:
            print(f"  {count:5d}x  {where}")
        check(waits[1] / meta["nfev"] <= DEVICE_FIT_WAITS,
              f"the applied fit waited {waits[1] / meta['nfev']:.2f} times"
              " per evaluation")
        BasicAnalysis._compiled_cache.clear()
        del dm
        torch.cuda.empty_cache()

        # the interpolated workflow over deltam31
        fit_dir = os.path.join(tmp, "interpolated")
        spec = {"deltam31": {"values": HS_DM31, "scales_log": False}}
        t0 = time.perf_counter()
        n_jobs = hs.prepare_interpolated_fit(fit_dir, spec, hs_fit_config())
        hs.run_interpolated_fit(fit_dir, 0, device="cuda")
        for job in range(n_jobs):  # job 0 resumed: skipped
            hs.run_interpolated_fit(fit_dir, job, skip_successful=True,
                                    device="cuda")
        check(hs.get_incomplete_job_idx(fit_dir) == [],
              "interpolated jobs left")
        out = os.path.join(tmp, "interpolated.json.bz2")
        hs.assemble_interpolated_fits(fit_dir, out)
        hs_rename_file(out)
        jobs_s = time.perf_counter() - t0
        launches = add()
        interp = Pipeline(hs_config(out, interpolated=True), device="cuda")
        maps = interp.get_outputs()
        check(all(np.isfinite(m.hist).all() for m in maps),
              "the interpolated template is not finite")
        ct = interp.compile()
        check(ct.stacked and "deltam31" not in ct.free_names,
              "the interpolated template")
        rel = maps_rel(ct.get_outputs(ct.current_rescaled_values()), maps)
        cwall, _ = median_wall(lambda: ct.get_outputs(
            ct.current_rescaled_values()), 10)
        launches_t = add()
        print(f"float32 interpolated workflow over deltam31 {HS_DM31}"
              f" (prepare, one job, the resume, assemble; {n_jobs} Pipeline"
              f" set-ups and fits): {jobs_s:.2f} s, launches {launches};"
              f" its template at deltam31 = {HS_DM31_POINT:g} eV^2 (fixed),"
              f" stacked captured: {rel:.3e} of the eager maps' largest"
              f" bins (bound {TEMPLATE_RTOL['float32']:g}), {cwall * 1e3:.3f}"
              f" ms a call with its read (median of 10), launches"
              f" {launches_t} [{smi}]")
        check(rel <= TEMPLATE_RTOL["float32"],
              "the interpolated captured template is off the eager one")
        del ct, interp

        # csv_hypersurfaces from the grid's fits, deltam31 free
        csv_pipeline = Pipeline(hs_config(csv_paths=hs_write_csv(out, tmp)),
                                device="cuda")
        maps = csv_pipeline.get_outputs()
        check(all(np.isfinite(m.hist).all() for m in maps),
              "the csv_hypersurfaces template is not finite")
        ct = csv_pipeline.compile()
        check(ct.stacked and "deltam31" in ct.free_names,
              "the csv_hypersurfaces template")
        data = {m.name: m.hist for m in maps}
        _, eager_vg = ct.build_objective(data, "mod_chi2", capture=False)
        got = read_back(eager_vg(torch.as_tensor(gradient_point(ct),
                                                 device=ct.device)))
        d_dm31 = float(got[1 + ct.free_names.index("deltam31")])
        add()
        print(f"float32 flagship with csv_hypersurfaces over deltam31"
              f" (free): d mod_chi2 / d deltam31 (rescaled) {d_dm31:.6e} at"
              f" gradient_point, gradient finite:"
              f" {bool(np.isfinite(got).all())} [{smi}]")
        check(np.isfinite(got).all() and d_dm31 != 0,
              "the csv_hypersurfaces gradient")
        vg_launches = measure_vg("flagship with csv_hypersurfaces, deltam31"
                                 " free", ct, chain, smi)
        check(vg_launches == expected_vg_launches(True),
              f"the csv_hypersurfaces value_and_grad launched {vg_launches}")
        add()
        del ct, csv_pipeline
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"hypersurfaces path launches (primal, tangent, multitangent):"
          f" {tuple(total)}, the datasets' of the timed fit"
          f" {datasets_launches} [{smi}]")
    check(total[0] >= 2 and total[2] >= 2, "the hypersurfaces path did not"
          " launch the primal and the multitangent")
    return tuple(total)


def hypersurfaces_only_main(chain, smi):
    """``--hypersurfaces-only``: the kernels built, then the hypersurfaces
    phases alone (the float64 child's and the main process's); no status
    line."""
    from pisa_tpu_torch.core.pipeline import Pipeline

    run_children([("hypersurfaces", ["--hypersurfaces-worker"])])
    t0 = time.perf_counter()
    pipeline = Pipeline(CFG, device="cuda")
    print(f"float32 Pipeline(...) setup on the card:"
          f" {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    launches = hypersurfaces_fp32(chain, pipeline, smi)
    print(f"float32 hypersurfaces phase: {time.perf_counter() - t0:.1f} s;"
          f" launches {launches}")
    return 0


# -- the command-line entry points and the llh server ---------------------------
def free_port():
    """A TCP port on localhost that no socket holds now."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def template_json(ref, binning, path):
    """The CPU float64 nominal template that the reference child left in
    `ref` (its ``cpu|nominal|w|`` and ``|e|`` arrays), written to `path` as
    a MapSet JSON over `binning`."""
    from pisa_tpu_torch.core.map import Map, MapSet

    prefix = "cpu|nominal|w|"
    MapSet([
        Map(name=key[len(prefix):], hist=w, binning=binning,
            error_hist=ref[f"cpu|nominal|e|{key[len(prefix):]}"])
        for key, w in ref.items() if key.startswith(prefix)
    ], name="cpu_fp64").to_json(path)


def cli_worker(path):
    """float64: the CPU nominal flagship template alone, for
    ``--cli-only`` (saved to `path` as the reference child saves it)."""
    import numpy as np

    from pisa_tpu_torch import FTYPE_NAME
    from pisa_tpu_torch.core.pipeline import Pipeline

    check(FTYPE_NAME == "fp64", f"cli worker runs {FTYPE_NAME}")
    maps = Pipeline(CFG, device="cpu").get_outputs()
    arrays = {}
    for m in maps:
        arrays[f"cpu|nominal|w|{m.name}"] = m.hist
        arrays[f"cpu|nominal|e|{m.name}"] = m.error_hist
    np.savez(path, **arrays)


def run_command(main_fn, argv):
    """`main_fn(argv)` (a command's entry point) in this process, its
    standard output echoed; returns (exit code, output, wall)."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main_fn(argv)
    wall = time.perf_counter() - t0
    sys.stdout.write(out.getvalue())
    return rc, out.getvalue(), wall


def cli_fp32(chain, pipeline, ref, smi):
    """Float32 at full width, the flagship through the port's commands,
    each called through its ``main(argv)`` in this process, the server in a
    child process: ``pipeline --compile --outdir`` held by ``compare``
    against the CPU float64 nominal template (`ref`, the reference child's)
    as ``compare()`` judges float32; ``analysis --method device`` against
    Asimov data at theta23 + 0.10 rescaled (from `pipeline`, the float32
    flagship on the card), recovering theta23 to FIT_TOL from the written
    state; ``python -m pisa_tpu_torch.utils.llh_server`` over the same
    data, whose first answer is timed from its start and whose CLI_REQUESTS
    answers at seeded points match this process's own ``-value_only(x)``
    to VG_FP32["value"]; ``benchmark -n 50`` and ``--in-device -n 100``.
    The server starts first, so its set-up overlaps the commands before
    it; its launches are its own. Returns the commands' (primal, tangent,
    multitangent) launches."""
    import re
    import shutil
    import threading

    import numpy as np
    import torch

    from pisa_tpu_torch.analysis.analysis import BasicAnalysis
    from pisa_tpu_torch.core.map import MapSet
    from pisa_tpu_torch.core.param import ParamSet
    from pisa_tpu_torch.scripts import analysis, benchmark
    from pisa_tpu_torch.scripts import compare as compare_command
    from pisa_tpu_torch.scripts import pipeline as pipeline_command
    from pisa_tpu_torch.utils.fileio import from_file
    from pisa_tpu_torch.utils.llh_client import Client

    started = time.perf_counter()
    total = [0, 0, 0]

    def add():
        for i, n in enumerate(launch_counts(chain)):
            total[i] += n
        reset_launch_counts(chain)

    tmp = tempfile.mkdtemp(prefix="cli_fp32_")
    server = None
    server_log = open(os.path.join(tmp, "server.log"), "w+")
    try:
        # the data: the flagship's eager template at theta23 + 0.10
        # rescaled
        pipeline.params.reset_all()
        v0 = np.asarray(pipeline.params.free._rescaled_values,
                        dtype=np.float64)
        truth = min(0.95, pipeline.params["theta23"]._rescaled_value + 0.10)
        pipeline.params["theta23"]._rescaled_value = truth
        data = pipeline.get_outputs()
        pipeline.params.reset_all()
        data_path = os.path.join(tmp, "asimov_theta23.json.bz2")
        data.to_json(data_path)

        # the server, in a child process; a thread times its first answer
        port = free_port()
        t_server = time.perf_counter()
        server = subprocess.Popen(
            [sys.executable, "-m", "pisa_tpu_torch.utils.llh_server",
             "--config", CFG, "--ref", data_path, "--port", str(port),
             "--metric", "llh"],
            cwd=ROOT, stdout=server_log, stderr=subprocess.STDOUT, text=True)
        first = {}

        def first_answer():
            while server.poll() is None:
                try:
                    with Client(("localhost", port)) as client:
                        first["llh"] = client.get_llh(v0)
                        first["s"] = time.perf_counter() - t_server
                        return
                except OSError:
                    time.sleep(0.05)

        waiter = threading.Thread(target=first_answer, daemon=True)
        waiter.start()
        cpu_path = os.path.join(tmp, "cpu_fp64_nominal.json.bz2")
        template_json(ref, pipeline.output_binning, cpu_path)
        print(f"command-line phase: data written, server started, reference"
              f" written {time.perf_counter() - started:.2f} s")
        reset_launch_counts(chain)

        # pipeline, then compare against the CPU float64 template
        out_dir = os.path.join(tmp, "pipeline")
        rc, _, wall = run_command(pipeline_command.main,
                                  [CFG, "--compile", "--outdir", out_dir])
        add()
        check(rc == 0, f"the pipeline command exited {rc}")
        test_path = os.path.join(out_dir, f"{pipeline.name}__outputs.json.bz2")
        print(f"float32 pipeline command (--compile --outdir): {wall:.2f} s"
              f" [{smi}]")
        rtol = TEMPLATE_RTOL["float32"]
        rc, _, _ = run_command(compare_command.main, [
            "--ref", cpu_path, "--ref-label", "cpu_fp64",
            "--test", test_path, "--test-label", "card_fp32",
            "--rtol", str(rtol), "--atol", str(rtol * MIN_EVENTS_FP32),
            "--outdir", tmp])
        check(rc == 0, f"compare exited {rc}: the pipeline command's template"
              " is off the CPU float64 one")
        written = MapSet.from_json(test_path)
        check(all(m.error_hist is not None for m in written),
              "the pipeline command wrote no errors")
        got = ({m.name: m.hist for m in written},
               {m.name: m.error_hist for m in written})
        check_template(got, "the pipeline command's float32 template")
        cpu = MapSet.from_json(cpu_path)
        compare(({m.name: m.hist for m in cpu},
                 {m.name: m.error_hist for m in cpu}), got,
                "nominal (pipeline command)", "float32", True)

        # analysis: the device fit from the nominal to the data
        result_path = os.path.join(tmp, "fit.json")
        rc, _, wall = run_command(analysis.main, [
            "-p", CFG, "--data", data_path, "--method", "device",
            "-o", result_path])
        add()
        BasicAnalysis._compiled_cache.clear()
        check(rc == 0, f"the analysis command exited {rc}")
        state = from_file(result_path)
        moved = (ParamSet.from_state(state["params"])["theta23"]
                 ._rescaled_value - truth)
        meta = state["minimizer_metadata"]
        print(f"float32 analysis command (--method device): wall {wall:.2f}"
              f" s, the fit {state['minimizer_time']:.3f} (its capture"
              f" included), nit {meta['nit']}, nfev {meta['nfev']}, theta23"
              f" off by {moved:.3e} rescaled (bound {FIT_TOL:g}) [{smi}]")
        check(abs(moved) <= FIT_TOL,
              "the analysis command's fit did not recover theta23")

        # the server's answers against this process's own objective (built
        # while the server may still be setting up)
        ct = pipeline.compile()
        check(np.array_equal(ct.current_rescaled_values(), v0),
              "the template's free parameters are not the pipeline's")
        value_only, _ = ct.build_objective(data, "llh")
        waiter.join(timeout=CLI_SERVER_TIMEOUT)
        check("s" in first and server.poll() is None,
              f"the llh server did not answer (exit code {server.poll()})")
        rng = np.random.RandomState(0)
        points = np.clip(v0 + rng.uniform(-0.1, 0.1, (CLI_REQUESTS, v0.size)),
                         0.05, 0.95)
        served, trips = [], []
        with Client(("localhost", port)) as client:
            for x in points:
                t0 = time.perf_counter()
                served.append(client.get_llh(x))
                trips.append(time.perf_counter() - t0)
        want = [-float(value_only(x)) for x in points]
        first_rel = abs(first["llh"] - -float(value_only(v0))) / abs(
            float(value_only(v0)))
        rel = max(abs(s - w) / abs(w) for s, w in zip(served, want))
        check(server.poll() is None, "the llh server died")
        print(f"float32 llh server (python -m pisa_tpu_torch.utils.llh_server,"
              f" one pipeline, the captured objective): first answer"
              f" {first['s']:.2f} s after its start (set-up and capture,"
              f" beside the commands above), {CLI_REQUESTS} requests at"
              f" seeded points: round trip median"
              f" {np.median(trips) * 1e3:.3f} ms, min {min(trips) * 1e3:.3f}"
              f" ms; served llh vs this process's -value_only(x): max rel"
              f" {max(rel, first_rel):.3e} (bound {VG_FP32['value']:g}) [{smi}]")
        check(max(rel, first_rel) <= VG_FP32["value"],
              "the served llh is off the in-process objective")
        del value_only
        server.terminate()
        server.wait(timeout=30)
        server = None

        # benchmark: the captured call, then the scan
        reset_launch_counts(chain)
        for args in (["-n", "50"], ["--in-device", "-n", "100"]):
            rc, out, wall = run_command(benchmark.main, [CFG, *args])
            add()
            rate = re.search(r"([\d.]+) templates/s", out)
            check(rc == 0 and rate is not None,
                  f"benchmark {' '.join(args)} printed no templates/s")
            print(f"float32 benchmark {' '.join(args)}: {rate.group(1)}"
                  f" templates/s (command wall {wall:.2f} s) [{smi}]")
        del ct
        torch.cuda.empty_cache()
    finally:
        if server is not None:
            server.kill()
            server.wait(timeout=30)
            server_log.seek(0)
            sys.stdout.write(server_log.read())
        server_log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"command-line path launches (primal, tangent, multitangent):"
          f" {tuple(total)} [{smi}]")
    check(total[0] > 0 and total[2] > 0, "the command-line path did not"
          " launch the primal and the multitangent")
    print(f"float32 command-line phase: {time.perf_counter() - started:.1f} s"
          f" (budget {CLI_BUDGET_S:g} s) [{smi}]")
    return tuple(total)


# -- the sharded flagship: parallel/ and CompiledTemplate.shard --------------
def sharded_worker():
    """float64 (``--sharded-worker``): the full flagship sharded over a
    gloo world of SHARDED_WORLD ranks, every one on cuda:0 (NCCL refuses two
    ranks on one card), each a process of its own
    (``pisa_tpu_torch/testing/sharded_worker.py``), eager; its template and
    mod_chi2 gradient against the unsharded card float64 ones (rank 0's),
    within SHARDED_FP64, with each rank's grid points, real layer steps and
    launches."""
    import numpy as np

    from pisa_tpu_torch.testing.sharded_worker import start_world

    t0 = time.perf_counter()
    ranks = start_world({"device": "cuda:0", "backend": "gloo",
                         "cases": ["card_flagship"], "grid_bins": None,
                         "fraction": None, "threads": 2},
                        SHARDED_WORLD).results(timeout=600)
    errors = [out["card_flagship|error"] for out in ranks
              if "card_flagship|error" in out]
    check(not errors, "the sharded float64 ranks failed:\n"
          + "\n".join(errors))
    want = ranks[0]
    worst_t = worst_e = worst_g = 0.0
    for rank, out in enumerate(ranks):
        for key in ("hist", "errors"):
            ref = want[f"card|unsharded|{key}"]
            got = out[f"card|sharded|{key}"]
            mask = ref != 0
            err = float(np.max(np.abs(got - ref)[mask] / np.abs(ref)[mask]))
            if key == "hist":
                worst_t = max(worst_t, err)
            else:
                worst_e = max(worst_e, err)
        worst_g = max(worst_g, grad_mismatch(
            out["card|sharded|grad"], want["card|unsharded|grad"],
            SHARDED_FP64["grad"], SHARDED_FP64["grad"]))
        print(f"float64 sharded rank {rank} of {SHARDED_WORLD} (gloo,"
              f" cuda:0): events {out['card|events'].tolist()}, grid points"
              f" {out['card|grid'].tolist()} ({out['card|points']} points"
              f" a sign, {out['card|layer_steps']} real layer steps a sign);"
              f" launches (primal, multitangent) of one template and one"
              f" eager value_and_grad {out['card|launches'].tolist()};"
              f" set-up {out['card|setup_s']:.2f} s, the case"
              f" {out['card_flagship|seconds']:.1f} s")
    print(f"float64 sharded flagship ({SHARDED_WORLD} gloo ranks on the card)"
          f" vs unsharded on the card: template {worst_t:.3e}, errors"
          f" {worst_e:.3e} relative per bin (bound"
          f" {SHARDED_FP64['template']:g}); gradient {worst_g:.3e} of its"
          f" bound ({SHARDED_FP64['grad']:g} relative per entry, plus"
          f" {SHARDED_FP64['grad']:g} of the largest); value"
          f" {ranks[1]['card|sharded|value']:.12e} vs"
          f" {want['card|unsharded|value']:.12e}; wall"
          f" {time.perf_counter() - t0:.1f} s")
    check(worst_t <= SHARDED_FP64["template"]
          and worst_e <= SHARDED_FP64["template"] and worst_g <= 1.0,
          "the sharded float64 flagship is off the unsharded one")
    check(all(out["card|launches"][0] > 0 and out["card|launches"][1] > 0
              for out in ranks), "a sharded rank launched no chain kernel")


def rank_slice_kernels(chain, prob3, smi):
    """The primal and the multitangent kernel (K = 3) at the grid slices
    of a world of SHARDED_WORLD ranks (20,000 points a sign each), float32:
    each against its plain version at the nominal theta, and timed
    device-only beside its bound. Returns {name: [(ms, bound, steps) per
    slice]}."""
    import numpy as np
    import torch

    energy, coszen = prob3._grid_points()
    n = energy.size
    out = {"osc_chain": [], "osc_chain_multitangent": []}
    theta = flagship_thetas({p.name: p for p in prob3.params})[0]
    pvec, jac = pack_and_directions(chain, theta, 1, torch.float32)
    dirs = jac[list(FREE_THETA)].contiguous()
    for rank in range(SHARDED_WORLD):
        part = slice(rank * n // SHARDED_WORLD, (rank + 1) * n // SHARDED_WORLD)
        geom = prob3._make_geometry(energy[part], *prob3._chains(coszen[part]))
        check(geom["e"].dtype == torch.float32, "the slice is not float32")
        args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
        steps = int((geom["dist"] > 0).sum())
        for name, run, plain, k, primal in (
                ("osc_chain",
                 lambda: chain.chain_probs(pvec, *args, geom["tiles"]),
                 lambda: chain.chain_probs_reference(pvec, *args), 0, True),
                ("osc_chain_multitangent",
                 lambda: chain.chain_multitangent(pvec, dirs, *args,
                                                  geom["tiles"]),
                 lambda: chain.chain_multitangent_reference(pvec, dirs,
                                                            *args),
                 len(FREE_THETA), True)):
            got, want = run(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            # the primal absolute (KERNEL_ATOL), the tangents relative to
            # their largest (TANGENT_RTOL)
            err = float((got[0] - want[0]).abs().max())
            check(err <= KERNEL_ATOL["float32"], f"{name} at rank {rank}'s"
                  f" slice: the primal {err} off the plain version")
            if k:
                rel = float((got[1] - want[1]).abs().max()
                            / want[1].abs().max())
                check(rel <= TANGENT_RTOL["float32"], f"{name} at rank"
                      f" {rank}'s slice: the tangents {rel} off the plain"
                      " version")
                err = max(err, rel)
            ms = graph_time(run)
            bound = kernel_bound(chain, geom, k, primal)
            out[name].append((ms, bound["bound_ms"], steps))
            print(f"float32 {name}{f' K = {k}' if k else ''} at rank {rank}'s"
                  f" grid slice of {SHARDED_WORLD} ({geom['e'].shape[0]}"
                  f" points, {steps} real layer steps): {ms:.5f} ms"
                  f" device-only, bound {bound['bound_ms']:.5f} ms by"
                  f" {bound['bound_by']}"
                  f" ({100 * bound['bound_ms'] / ms:.1f}%); vs plain"
                  f" {err:.3e} [{smi}]")
    return out


def sharded_fp32(chain, smi):
    """Float32 at full width (240k events, the 200x200 grid, 15 free): an
    NCCL world of one in this process (``init_multihost``), a flagship
    Pipeline of the phase's own, its template sharded over the mesh
    (``.compile().shard(default_mesh())``: the events and the grid split
    over the one rank, the collective run all the same) and its mod_chi2
    value_and_grad captured with the all_reduce in the graph, against the
    unsharded captured flagship on the same pipeline: the template within
    TEMPLATE_RTOL, the gradient within VG_FP32, both expected bit-equal.
    Prints the two value_and_grad walls, the launches (chain kernels and
    collectives), the replay's busy share and the phase's wall against
    SHARDED_BUDGET_S. The launches are the sharded template's own, counted
    from zero after the unsharded reference: its captured template and
    captured value_and_grad (each run CAPTURE_WARMUP times, then captured),
    which the phase returns as (primal, tangent, multitangent), and one
    eager value_and_grad, held to expected_vg_launches."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from pisa_tpu_torch.core import collectives
    from pisa_tpu_torch.core.pipeline import Pipeline
    from pisa_tpu_torch.core.template import CAPTURE_WARMUP
    from pisa_tpu_torch.parallel import default_mesh, multihost

    started = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multihost.init_multihost(f"127.0.0.1:{port}", 1, 0, device="cuda:0")
    try:
        check(default_mesh().backend == "nccl", "the world is not on NCCL")
        pipeline = Pipeline(CFG, device="cuda")
        ct = pipeline.compile()
        data = ct.get_outputs(ct.current_rescaled_values())
        v = gradient_point(ct)
        _, vg_ref = ct.build_objective(data, "mod_chi2")
        ref = read_back(vg_ref(v))
        t0 = time.perf_counter()
        sharded = pipeline.compile().shard(default_mesh())
        shard_s = time.perf_counter() - t0
        sc = sharded._trace_data.containers[0]
        geom = pipeline["osc.prob3"]._grid_geometry(sc)
        # the sharded path's own launches and collectives from here
        reset_launch_counts(chain)
        collectives.collective_count = 0
        maps = sharded.get_outputs()
        torch.cuda.synchronize()
        template_launches = launch_counts(chain)
        template_collectives = collectives.collective_count
        worst_t = worst_e = 0.0
        bit_equal = True
        for m in data:
            got = maps[m.name]
            mask = np.abs(m.hist) >= MIN_EVENTS_FP32
            worst_t = max(worst_t, max_rel(m.hist, got.hist, mask))
            worst_e = max(worst_e, max_rel(m.error_hist, got.error_hist,
                                           mask))
            bit_equal &= bool(np.array_equal(m.hist, got.hist)
                              and np.array_equal(m.error_hist,
                                                 got.error_hist))
        reset_launch_counts(chain)
        collectives.collective_count = 0
        t0 = time.perf_counter()
        value_fn, vg = sharded.build_objective(data, "mod_chi2")
        got = read_back(vg(v))
        capture_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        vg_collectives = collectives.collective_count
        vg_launches = launch_counts(chain)
        launches = tuple(a + b for a, b in zip(template_launches,
                                               vg_launches))
        reset_launch_counts(chain)
        _, eager = sharded.build_objective(data, "mod_chi2", capture=False)
        eager(torch.as_tensor(v, device="cuda"))
        torch.cuda.synchronize()
        eager_launches = launch_counts(chain)
        reset_launch_counts(chain)
        collectives_before = collectives.collective_count
        value_err = abs(got[0] - ref[0]) / abs(ref[0])
        grad_err = grad_mismatch(got[1:], ref[1:], VG_FP32["grad_rtol"],
                                 VG_FP32["grad_atol"])
        wall, wall_min = median_wall(lambda: read_back(vg(v)), 10)
        ref_wall, ref_min = median_wall(lambda: read_back(vg_ref(v)), 10)
        program = value_fn.program
        bounds = sharded._device_bounds()
        vec = torch.as_tensor(v, device="cuda")
        _, device_ms, top, _, kernels = profile_device_busy(
            lambda: program.value_and_grad(vec, *bounds))
        replay_collectives = collectives.collective_count - collectives_before
        ref_program = vg_ref.program
        _, ref_device_ms, _, _, ref_kernels = profile_device_busy(
            lambda: ref_program.value_and_grad(vec, *ct._device_bounds()))
        print(f"float32 sharded flagship over an NCCL world of"
              f" {dist.get_world_size()} (this process, cuda:0): shard()"
              f" {shard_s:.2f} s; events {list(sc.shard.events)} of"
              f" {sc.shard.n_events}, grid points"
              f" {list(sc.shard.grids.values())} ({int(geom['e'].shape[0])}"
              f" points a sign, {int(geom['nl'].sum())} real layer steps a"
              f" sign) [{smi}]")
        print(f"float32 sharded vs unsharded captured flagship: template"
              f" {worst_t:.3e}, errors {worst_e:.3e} relative in bins >="
              f" {MIN_EVENTS_FP32:g} event (bound"
              f" {TEMPLATE_RTOL['float32']:g}); value {value_err:.3e},"
              f" gradient {grad_err:.3e} of its bound (VG_FP32); bit-equal:"
              f" template {bit_equal}, value {got[0] == ref[0]}, gradient"
              f" {bool(np.array_equal(got[1:], ref[1:]))} (largest gradient"
              f" difference {float(np.abs(got[1:] - ref[1:]).max()):.3e})"
              f" [{smi}]")
        print(f"float32 sharded captured value_and_grad: wall"
              f" {wall * 1e3:.3f} ms median of 10 (min {wall_min * 1e3:.3f});"
              f" unsharded {ref_wall * 1e3:.3f} ms (min {ref_min * 1e3:.3f});"
              f" one replay {kernels} kernels, {device_ms:.3f} ms of device"
              f" time ({100 * device_ms / (wall * 1e3):.1f}% busy of the"
              f" median wall), unsharded {ref_kernels} kernels,"
              f" {ref_device_ms:.3f} ms ({100 * ref_device_ms / (ref_wall * 1e3):.1f}%"
              f" busy); capture with its first call {capture_s:.2f} s"
              f" [{smi}]")
        print(f"float32 sharded path's own launches (primal, tangent,"
              f" multitangent): captured template {template_launches},"
              f" captured value_and_grad {vg_launches} (each"
              f" {CAPTURE_WARMUP} warm-up runs and the capture), one eager"
              f" value_and_grad {eager_launches}; all_reduce calls: template"
              f" {template_collectives}, value_and_grad {vg_collectives} (a"
              f" replay adds {replay_collectives}) [{smi}]")
        for key, ms, count in top[:5]:
            print(f"  {ms:8.3f} ms  {count:5d}x  {key[:80]}")
        rank_slice_kernels(chain, pipeline["osc.prob3"], smi)
        reset_launch_counts(chain)
        check(worst_t <= TEMPLATE_RTOL["float32"]
              and worst_e <= TEMPLATE_RTOL["float32"],
              "the sharded float32 template is off the unsharded one")
        check(value_err <= VG_FP32["value"] and grad_err <= 1.0,
              "the sharded float32 value_and_grad is off the unsharded one")
        runs = CAPTURE_WARMUP + 1
        template_one, vg_one = (2, 0, 0), expected_vg_launches(True)
        check(template_launches == tuple(runs * n for n in template_one)
              and vg_launches == tuple(runs * (a + b) for a, b in
                                       zip(vg_one, template_one))
              and eager_launches == vg_one,
              f"the sharded path's launches: template {template_launches},"
              f" value_and_grad {vg_launches}, eager {eager_launches}")
        check(template_collectives > 0 and vg_collectives > 0,
              f"the sharded path's all_reduce calls: template"
              f" {template_collectives}, value_and_grad {vg_collectives}")
        del sharded, ct, pipeline, program, ref_program, value_fn, vg, vg_ref
        del eager
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    print(f"float32 sharded phase: {time.perf_counter() - started:.1f} s"
          f" (budget {SHARDED_BUDGET_S:g} s) [{smi}]")
    return launches


def api_inputs():
    """The helpers' seeded inputs: 240,000 events over the flagship's
    coordinates (some outside the output binning), values on the 200x200
    grid, and a mask keeping about half of the events; and the binnings
    (the flagship's grid and output binning, toy_fit_example's grid)."""
    import numpy as np

    from pisa_tpu_torch.config.parser import parse_pipeline_config

    cfg = parse_pipeline_config(CFG)
    fine = cfg[("osc", "prob3")]["calc_mode"]
    output = cfg[("utils", "hist")]["apply_mode"]
    coarse = parse_pipeline_config("settings/pipeline/toy_fit_example.cfg")[
        ("osc", "prob3")]["calc_mode"]
    rng = np.random.RandomState(22)
    n = API_EVENTS
    events = {
        "true_energy": 10 ** rng.uniform(0, 3, n),
        "true_coszen": rng.uniform(-1, 1, n),
        "reco_energy": 10 ** rng.uniform(0.5, 1.9, n),
        "reco_coszen": rng.uniform(-1, 1, n),
        "pid": rng.choice([0.0, 1.0], n),
        "weights": rng.uniform(0, 1e-3, n),
    }
    return (events, rng.uniform(0, 1, fine.size), rng.uniform(size=n) < 0.5,
            (fine, output, coarse))


def api_helpers(device, inputs):
    """The Container helpers on `device` in float64 (the values set as
    float64 tensors): {helper: host array}, {helper: wall in s}. The first
    call of each, as a user makes it: the index caches it builds
    included."""
    import torch

    from pisa_tpu_torch.core.container import Container

    events, grid_values, mask, (fine, output, coarse) = inputs
    c = Container("nu", device=device)
    for key, value in events.items():
        c[key] = torch.as_tensor(value, dtype=torch.float64, device=device)
    c.representation = fine
    c["prob"] = torch.as_tensor(grid_values, dtype=torch.float64,
                                device=device)
    c.representation = "events"

    def keep():
        c.keep(torch.as_tensor(mask, device=device))
        return torch.stack([c[k] for k in ("weights", "true_energy",
                                           "reco_energy", "pid")])

    calls = {
        "array_to_binned mean": lambda: c.array_to_binned(
            "weights", "events", output),
        "array_to_binned sum": lambda: c.array_to_binned(
            "weights", "events", output, averaged=False),
        "binned_to_array": lambda: c.binned_to_array("prob", fine, "events"),
        "resample": lambda: c.resample("prob", fine, coarse),
        "keep": keep,
    }
    out, walls = {}, {}
    for name, call in calls.items():
        t0 = time.perf_counter()
        result = call()
        if result.is_cuda:
            torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        check(result.dtype == torch.float64, f"{name}: {result.dtype}")
        out[name] = result.cpu().numpy()
    return out, walls


def api_fp32(chain, smi):
    """The public surface the port completed last, in the float32 process:
    each of API_SERVICES through ``service_matrix.run_service`` in both
    modes on the card, then on the CPU: each status the CPU's, none a
    failure or without an init_test (the gated two skip where their package
    is missing, on both); the chain kernel launched by prob3's. Then the
    Container helpers in float64 on the card against the same calls on the
    CPU, each within API_TOL of the largest entry. Prints the statuses, the
    helpers' card walls and worst errors, and the phase's wall against
    API_BUDGET_S; returns the services' launches on the card (primal,
    tangent, multitangent)."""
    import numpy as np
    import torch

    from pisa_tpu_torch.testing import service_matrix

    started = time.perf_counter()

    def statuses(device):
        """{(service, mode): (status, wall in s)} on `device`."""
        out = {}
        for service in API_SERVICES:
            for mode in ("events", "map"):
                t0 = time.perf_counter()
                status = service_matrix.run_service(*service, mode,
                                                    device=device)
                if device == "cuda":
                    torch.cuda.synchronize()
                out[(service, mode)] = (status, time.perf_counter() - t0)
        return out

    reset_launch_counts(chain)
    card = statuses("cuda")
    launches = launch_counts(chain)
    card_wall = time.perf_counter() - started
    t0 = time.perf_counter()
    cpu = statuses("cpu")
    cpu_wall = time.perf_counter() - t0
    for key, (status, wall) in card.items():
        name, mode = ".".join(key[0]), key[1]
        want, cpu_s = cpu[key]
        print(f"public API: {name} {mode}: card {status!r} ({wall:.3f} s),"
              f" CPU {want!r} ({cpu_s:.3f} s)")
        check(status == want,
              f"{name} {mode}: {status!r} on the card, {want!r} on the CPU")
        check(not status.startswith("FAIL") and status != "no init_test",
              f"{name} {mode}: {status!r}")
    check(launches[0] > 0, f"the services' launches on the card {launches}")
    print(f"public API: {len(API_SERVICES)} services in both modes, card"
          f" {card_wall:.2f} s, CPU {cpu_wall:.2f} s; launches (primal,"
          f" tangent, multitangent) on the card {launches} [{smi}]")

    inputs = api_inputs()
    got, walls = api_helpers("cuda", inputs)
    want, cpu_walls = api_helpers("cpu", inputs)
    worst = 0.0
    for name, ref in want.items():
        check(got[name].shape == ref.shape and np.all(np.isfinite(got[name])),
              f"{name}: shape {got[name].shape}, CPU {ref.shape}")
        err = float(np.abs(got[name] - ref).max() / np.abs(ref).max())
        worst = max(worst, err)
        print(f"public API: {name} float64, {ref.shape}: card"
              f" {walls[name] * 1e3:.2f} ms, CPU {cpu_walls[name] * 1e3:.2f}"
              f" ms, card vs CPU {err:.3e} of the largest entry (bound"
              f" {API_TOL:g}) [{smi}]")
        check(err <= API_TOL, f"{name}: card vs CPU {err:.3e}")
    print(f"float32 public API phase: {time.perf_counter() - started:.1f} s"
          f" (budget {API_BUDGET_S:g} s), worst helper error {worst:.3e}"
          f" [{smi}]")
    return launches


def api_only_main(chain, smi):
    """``--api-only``: the kernels built, then the public-surface phase
    alone; no status line."""
    api_fp32(chain, smi)
    return 0


def sharded_only_main(chain, smi):
    """``--sharded-only``: the kernels built, the float64 sharded child,
    then the float32 sharded phase; no status line."""
    run_children([("sharded", ["--sharded-worker"])])
    sharded_fp32(chain, smi)
    return 0


def cli_only_main(chain, smi):
    """``--cli-only``: the kernels built, the CPU float64 nominal template
    in a child, then the command-line phase alone; no status line."""
    import numpy as np

    from pisa_tpu_torch.core.pipeline import Pipeline

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cli.npz")
        run_children([("CPU nominal template", ["--cli-worker", path])])
        with np.load(path) as f:
            ref = {k: f[k] for k in f.files}
    t0 = time.perf_counter()
    pipeline = Pipeline(CFG, device="cuda")
    print(f"float32 Pipeline(...) setup on the card:"
          f" {time.perf_counter() - t0:.2f} s")
    cli_fp32(chain, pipeline, ref, smi)
    return 0


def print_kernel_times(kernels, smi):
    for name, k in kernels.items():
        for dname, t in k.items():
            print(f"kernel {name} {dname}: {t['ms']:.5f} ms device-only,"
                  f" {t['host_ms']:.5f} ms with enqueue, plain"
                  f" {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms by"
                  f" {t['bound_by']}; {t['registers']} registers,"
                  f" {t['blocks_per_sm']} blocks of {t['threads']} per SM"
                  f" [{smi}]")


def release_only_main(chain, smi):
    """``--release-only``: the kernels built, then the release phases alone
    (the float64 child's and the main process's); no status line."""
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "release.npz")
        env = dict(os.environ, PISA_TPU_FTYPE="fp64")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--release-worker", path], env=env, check=True)
        with np.load(path) as f:
            ref = {k: f[k] for k in f.files}
    t0 = time.perf_counter()
    release_fp32(chain, ref, smi)
    print(f"float32 release phase: {time.perf_counter() - t0:.1f} s")
    return 0


def analysis_only_main(chain, smi):
    """``--analysis-only``: the kernels built, then the phases of the rest
    of the analysis layer alone (the float64 child's and the main
    process's, on a fresh flagship pipeline); no status line."""
    from pisa_tpu_torch.core.pipeline import Pipeline

    t0 = time.perf_counter()
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--analysis-worker"],
                   env=dict(os.environ, PISA_TPU_FTYPE="fp64"), check=True)
    print(f"float64 child (metrics, generalized, Fisher):"
          f" {time.perf_counter() - t0:.1f} s")
    pipeline = Pipeline(CFG, device="cuda")
    for label, phase in (("metrics", metrics_fp32), ("fisher", fisher_fp32),
                         ("mcmc", mcmc_fp32)):
        t0 = time.perf_counter()
        launches = phase(pipeline, chain, smi)
        print(f"float32 {label} phase: {time.perf_counter() - t0:.1f} s;"
              f" launches {launches}")
    return 0


def main(kernels_only=False, release_only=False, analysis_only=False,
         options_only=False, lanes_only=False, sterile_only=False,
         events_only=False, hypersurfaces_only=False, mceq_only=False,
         param_only=False, cli_only=False, sharded_only=False,
         api_only=False):
    started = time.perf_counter()
    if not os.path.isdir(os.path.join(ROOT, "pisa_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository"
              " (pisa_tpu_torch/ not found beside it)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    os.environ["PISA_TPU_FTYPE"] = "fp32"
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs one NVIDIA card",
              file=sys.stderr)
        return 1

    from pisa_tpu_torch import ureg
    from pisa_tpu_torch.core.pipeline import Pipeline
    from pisa_tpu_torch.ops.osc import chain

    smi = device_lines()
    # whether h5py is installed, without importing it: the port reads HDF5
    # with its own reader (utils/hdf5_reader.py)
    import importlib.util

    print(f"h5py installed: {importlib.util.find_spec('h5py') is not None}")
    build_kernel(chain)
    if sterile_only:
        return sterile_only_main(chain, smi)
    if events_only:
        return events_only_main(chain, smi)
    if hypersurfaces_only:
        return hypersurfaces_only_main(chain, smi)
    if mceq_only:
        return mceq_only_main(chain, smi)
    if param_only:
        return param_only_main(chain, smi)
    if cli_only:
        return cli_only_main(chain, smi)
    if sharded_only:
        return sharded_only_main(chain, smi)
    if api_only:
        return api_only_main(chain, smi)
    if release_only:
        return release_only_main(chain, smi)
    if analysis_only:
        return analysis_only_main(chain, smi)
    if options_only:
        return osc_options_only_main(chain, smi)
    if lanes_only:
        return osc_lanes_only_main(chain, smi)
    kernels = {
        "osc_chain": kernel_vs_plain(chain),
        "osc_chain_tangent": tangent_vs_plain(chain),
        "osc_chain_multitangent": multitangent_vs_plain(chain),
    }
    lanes = lane_kernels(chain)
    general_pack_kernels(chain)
    general_lanes = general_lane_kernels(chain)
    print_kernel_times(kernels, smi)
    kde_kernels = kde_checks(smi)
    if kernels_only:
        herm4_vs_plain(smi)
        return 0

    # float64, card against CPU: every child process at once (their CPU
    # sides dominate, and none depends on another), before the float32
    # phases, whose timings then run alone
    # the events-file child's file and float64 template, read by
    # events_file_fp32
    events_dir = tempfile.TemporaryDirectory(prefix="events_file_fp64_")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reference.npz")
        run_children([
            ("CPU reference + card run", ["--reference-worker", path]),
            ("metrics, generalized, Fisher", ["--analysis-worker"]),
            ("options", ["--osc-options-worker"]),
            ("options lanes", ["--osc-lanes-worker"]),
            ("sterile", ["--sterile-worker"]),
            ("events", ["--events-worker"]),
            ("hypersurfaces", ["--hypersurfaces-worker"]),
            ("MCEq", ["--mceq-worker"]),
            ("parameterized detector", ["--param-worker"]),
            ("events file", ["--events-file-worker", events_dir.name]),
            ("sharded", ["--sharded-worker"]),
        ])
        with np.load(path) as f:
            ref = {k: f[k] for k in f.files}
    print(f"CPU float64 reference, 3 templates: {float(ref['cpu_seconds']):.2f}"
          " s")

    def unpack(tag, label):
        w = {k.split("|")[3]: v for k, v in ref.items()
             if k.startswith(f"{tag}|{label}|w|")}
        e = {k.split("|")[3]: v for k, v in ref.items()
             if k.startswith(f"{tag}|{label}|e|")}
        return w, e

    for label, _, _ in param_points(ureg):
        cpu = unpack("cpu", label)
        check_template(cpu, f"CPU float64 {label}")
        check_template(unpack("gpu", label), f"card float64 {label}")
        compare(cpu, unpack("gpu", label), label, "float64", False)
        print(f"float64 card {label}: {int(ref[f'launches|{label}'])} kernel"
              " launches")
    check_gradient_fp64(ref)

    # float32, the eager template path on the card
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipeline = Pipeline(CFG, device="cuda")
    torch.cuda.synchronize()
    print(f"float32 Pipeline(...) setup on the card:"
          f" {time.perf_counter() - t0:.2f} s")
    reset_launch_counts(chain)
    out, launches = run_points(pipeline, ureg, chain)
    eager_launches = launch_counts(chain)
    torch.cuda.synchronize()
    for label, _, osc_changed in param_points(ureg):
        total = check_template(out[label], f"card float32 {label}")
        compare(unpack("cpu", label), out[label], label, "float32", True)
        print(f"float32 card {label}: {total:.3f} expected events,"
              f" {launches[label]} kernel launches")
        check(launches[label] == (2 if osc_changed else 0),
              f"float32 {label}: {launches[label]} kernel launches")
    check(eager_launches == (4, 0, 0),
          f"the eager path's launches {eager_launches}")

    # get_outputs wall time: with an oscillation recompute, and cached
    walls = {"recompute": [], "cached": []}
    for i in range(10):
        pipeline.params["theta23"].value = (42.0 + 0.1 * i) * ureg.degree
        t0 = time.perf_counter()
        pipeline.get_outputs()
        torch.cuda.synchronize()
        walls["recompute"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        pipeline.get_outputs()
        torch.cuda.synchronize()
        walls["cached"].append(time.perf_counter() - t0)
    for kind, ts in walls.items():
        print(f"float32 get_outputs wall ({kind}, 10 runs): median"
              f" {np.median(ts) * 1e3:.2f} ms, min {min(ts) * 1e3:.2f} ms"
              f" [{smi}]")
    print(f"torch.cuda.max_memory_allocated (float32 pipeline):"
          f" {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB [{smi}]")

    # float32, the gradient and fit path on the card
    t0 = time.perf_counter()
    fit_path, _ = gradient_and_fit_fp32(pipeline, chain, ref, smi)
    print(f"float32 gradient and fit phase: {time.perf_counter() - t0:.1f} s")
    # float32, the captured template call
    t0 = time.perf_counter()
    template_path, _ = template_fp32(pipeline, chain, smi)
    print(f"float32 template phase: {time.perf_counter() - t0:.1f} s")
    # float32, fits through the analysis layer
    t0 = time.perf_counter()
    analysis_path = analysis_fp32(chain, ureg, smi)
    print(f"float32 analysis phase: {time.perf_counter() - t0:.1f} s")
    # float32, the batched fits
    t0 = time.perf_counter()
    ensemble_path = ensemble_fp32(chain, smi)
    print(f"float32 ensemble phase: {time.perf_counter() - t0:.1f} s")
    # float32, the release's fit to the released counts (this slice's main
    # path)
    t0 = time.perf_counter()
    release_path = release_fp32(chain, ref, smi)
    print(f"float32 release phase: {time.perf_counter() - t0:.1f} s")
    # float32: the MC-uncertainty metrics and the nlopt fits, the Fisher
    # matrix, the ensemble sampler
    extra_paths = {}
    for label, phase in (("metrics", metrics_fp32), ("fisher", fisher_fp32),
                         ("mcmc", mcmc_fp32)):
        t0 = time.perf_counter()
        extra_paths[label] = phase(pipeline, chain, smi)
        print(f"float32 {label} phase: {time.perf_counter() - t0:.1f} s")
    # prob3's options at full width through the entry points
    t0 = time.perf_counter()
    extra_paths["options"] = osc_options_fp32(chain, smi)
    print(f"float32 options phase: {time.perf_counter() - t0:.1f} s")
    # forward mode and lanes under the options
    t0 = time.perf_counter()
    extra_paths["options lanes"] = options_lanes_fp32(chain, smi)
    print(f"float32 options lanes phase: {time.perf_counter() - t0:.1f} s")
    # 3+1 sterile oscillations and the 3-flavour nusquids route: herm4_eig
    # against its plain version, then float32 at full width. The kernel
    # checks run here, after route_table, whose check counts the copies the
    # profiler sees on the card: with them (and their switch to MAGMA and
    # back) before it, one run's profiler saw no copy in a captured
    # value_and_grad at all.
    t0 = time.perf_counter()
    herm4_kernel = herm4_vs_plain(smi)
    sterile_resonance_fp32(smi)
    print(f"herm4_eig checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    extra_paths["sterile"], herm4_launches = sterile_fp32(chain, smi)
    print(f"float32 sterile phase: {time.perf_counter() - t0:.1f} s")
    # the HDF5 event path and the KDE stage at full width (this slice's
    # main path)
    t0 = time.perf_counter()
    extra_paths["events"], kde_path = events_fp32(chain, smi)
    print(f"float32 events phase: {time.perf_counter() - t0:.1f} s")
    # the events-file workflow on the port's HDF5 writer, example.cfg from
    # the written file and the laned scatter-added histogram (this slice's
    # main path)
    extra_paths["events file"] = events_file_fp32(chain, events_dir.name,
                                                  smi)
    events_dir.cleanup()
    # hypersurfaces fitted on the flagship and applied to it (this slice's
    # main path)
    t0 = time.perf_counter()
    extra_paths["hypersurfaces"] = hypersurfaces_fp32(chain, pipeline, smi)
    print(f"float32 hypersurfaces phase: {time.perf_counter() - t0:.1f} s")
    # the MCEq-Barr flagship at full width (this slice's main path)
    t0 = time.perf_counter()
    extra_paths["MCEq"] = mceq_fp32(chain, smi)
    print(f"float32 MCEq phase: {time.perf_counter() - t0:.1f} s")
    # the parameterized-detector path at full width (this slice's main path)
    t0 = time.perf_counter()
    extra_paths["parameterized detector"] = param_fp32(chain, smi)
    print(f"float32 parameterized-detector phase:"
          f" {time.perf_counter() - t0:.1f} s")
    # the command-line entry points and the llh server on the flagship
    # (this slice's main path)
    extra_paths["command line"] = cli_fp32(chain, pipeline, ref, smi)
    # the flagship sharded over an NCCL world of one, its value_and_grad
    # captured with the collective (this slice's main path)
    extra_paths["sharded"] = sharded_fp32(chain, smi)
    # the public surface completed last: the services' init_tests on the
    # card and the Container helpers (this slice's main path)
    extra_paths["public API"] = api_fp32(chain, smi)
    print(f"launches (primal, tangent, multitangent) by path: gradient and fit"
          f" {fit_path}, template {template_path}, analysis {analysis_path},"
          f" ensemble {ensemble_path}, release {release_path}, "
          + ", ".join(f"{k} {v}" for k, v in extra_paths.items()))
    main_path = tuple(sum(c) for c in zip(fit_path, template_path,
                                          analysis_path, ensemble_path,
                                          release_path,
                                          *extra_paths.values()))

    print_kernel_times(kernels, smi)
    lines = []
    for (name, replaces), launches in zip(KERNELS.items(), main_path):
        k = kernels[name]["float32"]
        lane = lanes[name]["float32"]
        lines.append({
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            "library_ms": None,
            "dtype": "float32",
            "max_rel_err": k.get("max_rel_err"),
            "host_ms": k["host_ms"],
            "registers": k["registers"],
            "local_bytes": k["local_bytes"],
            "threads": k["threads"],
            "blocks_per_sm": k["blocks_per_sm"],
            # one launch over several lanes (the batched fits), device-only,
            # beside as many single launches, with its bound
            "lanes_max_abs_err": lane["max_abs_err"],
            "lanes": {str(b): t for b, t in lane["lanes"].items()},
            # GENERAL_LANES lanes of general (NSI, LRI) packs in one
            # launch, by K
            "general_lanes_max_abs_err":
                general_lanes[name]["float32"]["max_abs_err"],
            "general_lanes": {str(k): t for k, t in
                              general_lanes[name]["float32"]["times"].items()},
        })
    k = herm4_kernel["float32"]
    lines.append({
        "name": "herm4_eig",
        "route": "cuda",
        "source": HERM4_SOURCE,
        "replaces": HERM4_REPLACES,
        "launches": herm4_launches,
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": k["library_ms"],
        "dtype": "float32",
        "max_rel_err": k["max_rel_err"],
        "library_call": f"torch.linalg.eigvalsh ({k['library_backend']}"
                        " backend)",
        "registers": k["registers"],
        "local_bytes": k["local_bytes"],
        "threads": k["threads"],
        "blocks_per_sm": k["blocks_per_sm"],
        "sweeps_mean": k["sweeps_mean"],
    })
    for name, launches in zip(("kde_gauss_sum", "kde_gauss_sum_vjp",
                               "kde_gauss_sum_jvp"), kde_path):
        k = kde_kernels[name]["float32"]
        lines.append({
            "name": name,
            "route": "cuda",
            "source": KDE_SOURCE,
            "replaces": KDE_REPLACES,
            "launches": launches,
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            # no single PyTorch call computes a weighted sum of Gaussian
            # kernels with per-sample widths
            "library_ms": None,
            "dtype": "float32",
            "max_rel_err": k["max_rel_err"],
            "max_rel_err_vs_float64": k["max_rel_err_vs_float64"],
            "registers": k["registers"],
            "local_bytes": k["local_bytes"],
            "threads": k["threads"],
            "blocks_per_sm": k["blocks_per_sm"],
        })
        if name == "kde_gauss_sum_jvp":
            # the dense pilot at K = 1 above (the earlier design's shape);
            # the live passes at K = 1 and at the Fisher matrix's K here,
            # and every pass's errors
            lines[-1].update(
                shape_BDNM=k["shape"],
                float64={key: kde_kernels[name]["float64"][key]
                         for key in ("ms", "plain_ms", "plain_directions",
                                     "bound_ms", "bound_by", "max_rel_err")},
                **{key: k[key] for key in (
                    "live_pilot", "live_grid", f"live_pilot_K{KDE_JVP_K}",
                    f"live_grid_K{KDE_JVP_K}")},
                checks={dname: kde_kernels[name][dname]["checks"]
                        for dname in ("float32", "float64")})
            continue
        # the sum and the vjp: live pairs above, dense here
        lines[-1].update(
            shape_BDNM=k["shape"], grid_pass=k["grid"],
            float64={key: kde_kernels[name]["float64"][key]
                     for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "max_rel_err")},
            float64_grid_pass=kde_kernels[name]["float64"]["grid"],
            live_pairs=k["pairs"], splits=k["splits"],
            outputs_per_thread=k["outputs_per_thread"],
            dense_bound_ms=k["dense_bound_ms"],
            dense_pilot=k["dense"], dense_grid_pass=k["dense_grid"],
            float64_dense_pilot=kde_kernels[name]["float64"]["dense"])
    print(f"chip_smoke.py total wall: {time.perf_counter() - started:.1f} s"
          f" [{smi}]")
    print(json.dumps({"kernels": lines}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    workers = {"--analysis-worker": analysis_worker,
               "--osc-options-worker": osc_options_worker,
               "--osc-lanes-worker": options_lanes_worker,
               "--sterile-worker": sterile_worker,
               "--events-worker": events_worker,
               "--hypersurfaces-worker": hypersurfaces_worker,
               "--mceq-worker": mceq_worker,
               "--param-worker": param_worker,
               "--sharded-worker": sharded_worker}
    if len(sys.argv) == 2 and sys.argv[1] in workers:
        sys.path.insert(0, ROOT)
        os.chdir(ROOT)
        workers[sys.argv[1]]()
        sys.exit(0)
    path_workers = {"--reference-worker": reference_worker,
                    "--release-worker": release_worker,
                    "--cli-worker": cli_worker,
                    "--events-file-worker": events_file_worker}
    if len(sys.argv) == 3 and sys.argv[1] in path_workers:
        sys.path.insert(0, ROOT)
        os.chdir(ROOT)
        path_workers[sys.argv[1]](sys.argv[2])
        sys.exit(0)
    sys.exit(main(kernels_only=sys.argv[1:] == ["--kernels-only"],
                  release_only=sys.argv[1:] == ["--release-only"],
                  analysis_only=sys.argv[1:] == ["--analysis-only"],
                  options_only=sys.argv[1:] == ["--osc-options-only"],
                  lanes_only=sys.argv[1:] == ["--osc-lanes-only"],
                  sterile_only=sys.argv[1:] == ["--sterile-only"],
                  events_only=sys.argv[1:] == ["--events-only"],
                  hypersurfaces_only=sys.argv[1:] == ["--hypersurfaces-only"],
                  mceq_only=sys.argv[1:] == ["--mceq-only"],
                  param_only=sys.argv[1:] == ["--param-only"],
                  cli_only=sys.argv[1:] == ["--cli-only"],
                  sharded_only=sys.argv[1:] == ["--sharded-only"],
                  api_only=sys.argv[1:] == ["--api-only"]))
