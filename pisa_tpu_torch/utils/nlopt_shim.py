"""Pure-Python, scipy-backed implementation of the ``nlopt`` API surface
used by :mod:`pisa_tpu_torch.analysis.analysis` (``_fit_nlopt_real`` /
``_define_nlopt_opt``); the port's own copy of ``pisa_tpu/utils/nlopt_shim.py``
(numpy and scipy only).

The reference framework *requires* the nlopt package
(cf. reference ``setup.py:86-115``) and drives it through
``pisa/analysis/analysis.py:2218-2470``.  nlopt is not installable in
every deployment, so this module provides a drop-in shim with the same
call surface — ``opt`` objects, ``set_min_objective``, stopping
criteria, ``add_inequality_constraint``, ``set_local_optimizer``
(MLSL / AUGLAG subsidiary optimizers), ``srand``, result codes — backed
by :mod:`scipy.optimize`.  ``analysis._import_nlopt()`` resolves to the
real package when importable and to this shim otherwise, so the full
reference fit schema executes either way.

Semantics intentionally mirrored from nlopt:

* objective / constraint callables take ``(x, grad)`` with an EMPTY
  ``grad`` array for the derivative-free algorithms implemented here;
* ``maxeval`` / ``maxtime`` / ``stopval`` are enforced across the whole
  optimization (including MLSL restarts and AUGLAG outer iterations)
  and reported via ``last_optimize_result()`` codes 5 / 6 / 2;
* inequality constraints are feasible when ``f(x) <= 0`` and are only
  supported on the algorithms that support them in nlopt proper
  (COBYLA, ISRES, AUGLAG) — others raise ``invalid_argument``;
* ``AUGLAG`` is a genuine augmented-Lagrangian outer loop over the
  subsidiary ``local_optimizer``;
* ``G_MLSL`` / ``G_MLSL_LDS`` are multi-start loops over the
  subsidiary local optimizer (LDS = scrambled-Sobol start points).
"""

from __future__ import annotations

import time

import numpy as np
from scipy import optimize as spo

__all__ = [
    "opt", "srand", "invalid_argument", "ForcedStop",
    "SUCCESS", "STOPVAL_REACHED", "FTOL_REACHED", "XTOL_REACHED",
    "MAXEVAL_REACHED", "MAXTIME_REACHED",
    "FAILURE", "INVALID_ARGS", "OUT_OF_MEMORY", "ROUNDOFF_LIMITED",
    "FORCED_STOP",
]

# --------------------------------------------------------------------- #
# result codes (numeric values match nlopt's enum)                       #
# --------------------------------------------------------------------- #
SUCCESS = 1
STOPVAL_REACHED = 2
FTOL_REACHED = 3
XTOL_REACHED = 4
MAXEVAL_REACHED = 5
MAXTIME_REACHED = 6
FAILURE = -1
INVALID_ARGS = -2
OUT_OF_MEMORY = -3
ROUNDOFF_LIMITED = -4
FORCED_STOP = -5


class invalid_argument(ValueError):  # noqa: N801 - nlopt spelling
    """Mirror of ``nlopt.invalid_argument``."""


class ForcedStop(RuntimeError):
    """Mirror of ``nlopt.ForcedStop``."""


# --------------------------------------------------------------------- #
# algorithm enum                                                         #
# --------------------------------------------------------------------- #
_ALGORITHM_NAMES = [
    # local derivative-free
    "LN_NELDERMEAD", "LN_SBPLX", "LN_COBYLA", "LN_BOBYQA", "LN_PRAXIS",
    "LN_NEWUOA", "LN_NEWUOA_BOUND",
    # global derivative-free
    "GN_DIRECT", "GN_DIRECT_L", "GN_DIRECT_L_RAND",
    "GN_ORIG_DIRECT", "GN_ORIG_DIRECT_L",
    "GN_CRS2_LM", "GN_ESCH", "GN_ISRES",
    # multi-start loops (need a subsidiary local optimizer)
    "G_MLSL", "G_MLSL_LDS", "GN_MLSL", "GN_MLSL_LDS",
    # augmented Lagrangian (constraints via subsidiary optimizer)
    "AUGLAG", "AUGLAG_EQ", "LN_AUGLAG", "LN_AUGLAG_EQ",
]
# distinct ints so getattr(nlopt, name) / dispatch both work
_ALGO_BY_CODE = {}
for _i, _name in enumerate(_ALGORITHM_NAMES):
    globals()[_name] = _i
    _ALGO_BY_CODE[_i] = _name

#: algorithms that accept nonlinear inequality constraints directly
#: (nlopt returns INVALID_ARGS for the rest)
_CONSTRAINT_CAPABLE = {"LN_COBYLA", "GN_ISRES",
                       "AUGLAG", "AUGLAG_EQ", "LN_AUGLAG", "LN_AUGLAG_EQ"}
_MLSL = {"G_MLSL", "G_MLSL_LDS", "GN_MLSL", "GN_MLSL_LDS"}
_AUGLAG = {"AUGLAG", "AUGLAG_EQ", "LN_AUGLAG", "LN_AUGLAG_EQ"}

# module RNG, reseedable via srand() (nlopt.srand semantics)
_RNG = np.random.default_rng(0)


def srand(seed):
    """Seed the shim's global RNG (mirrors ``nlopt.srand``)."""
    global _RNG
    _RNG = np.random.default_rng(int(seed))


_EMPTY_GRAD = np.empty(0, dtype=np.float64)


class _Stop(Exception):
    """Internal control-flow stop raised inside the counting wrapper."""

    def __init__(self, code):
        self.code = code


class opt:  # noqa: N801 - nlopt spelling
    """Shim of ``nlopt.opt`` for the derivative-free algorithm families
    the analysis layer drives (cf. reference ``analysis.py:2398-2460``).
    """

    def __init__(self, algorithm, n):
        try:
            self._algo_name = _ALGO_BY_CODE[int(algorithm)]
        except (KeyError, TypeError, ValueError):
            raise invalid_argument(f"unknown algorithm {algorithm!r}")
        self._n = int(n)
        self._objective = None
        self._ftol_abs = None
        self._ftol_rel = None
        self._xtol_abs = None
        self._xtol_rel = None
        self._stopval = None
        self._maxeval = 0          # nlopt: 0 or negative = no limit
        self._maxtime = 0.0
        self._params = {}
        self._constraints = []     # list of (fn, tol)
        self._population = 0
        self._initial_step = None
        self._lb = np.full(self._n, -np.inf)
        self._ub = np.full(self._n, +np.inf)
        self._local = None
        # run state
        self._numevals = 0
        self._last_result = FAILURE
        self._last_value = np.inf

    # ----------------------------------------------------------------- #
    # configuration surface                                              #
    # ----------------------------------------------------------------- #
    def set_min_objective(self, fn):
        self._objective = fn

    def set_ftol_abs(self, v):
        self._ftol_abs = float(v)

    def set_ftol_rel(self, v):
        self._ftol_rel = float(v)

    def set_xtol_abs(self, v):
        self._xtol_abs = np.broadcast_to(
            np.asarray(v, dtype=np.float64), (self._n,)
        ).copy()

    def set_xtol_rel(self, v):
        self._xtol_rel = float(v)

    def set_stopval(self, v):
        self._stopval = float(v)

    def set_maxeval(self, v):
        self._maxeval = int(v)

    def set_maxtime(self, v):
        self._maxtime = float(v)

    def set_param(self, name, v):
        self._params[str(name)] = v

    def add_inequality_constraint(self, fn, tol=0.0):
        if self._algo_name not in _CONSTRAINT_CAPABLE:
            raise invalid_argument(
                f"{self._algo_name} does not support nonlinear"
                " inequality constraints (use AUGLAG, LN_COBYLA or"
                " GN_ISRES)"
            )
        self._constraints.append((fn, float(tol)))

    def set_population(self, v):
        self._population = int(v)

    def set_initial_step(self, v):
        self._initial_step = np.broadcast_to(
            np.asarray(v, dtype=np.float64), (self._n,)
        ).copy()

    def set_lower_bounds(self, v):
        self._lb = np.broadcast_to(
            np.asarray(v, dtype=np.float64), (self._n,)
        ).copy()

    def set_upper_bounds(self, v):
        self._ub = np.broadcast_to(
            np.asarray(v, dtype=np.float64), (self._n,)
        ).copy()

    def set_local_optimizer(self, local):
        self._local = local

    # ----------------------------------------------------------------- #
    # result surface                                                     #
    # ----------------------------------------------------------------- #
    def last_optimize_result(self):
        return self._last_result

    def last_optimum_value(self):
        return self._last_value

    def get_numevals(self):
        return self._numevals

    def get_algorithm_name(self):
        return f"{self._algo_name} (scipy-backed shim)"

    def get_lower_bounds(self):
        return self._lb.copy()

    def get_upper_bounds(self):
        return self._ub.copy()

    # ----------------------------------------------------------------- #
    # optimization                                                       #
    # ----------------------------------------------------------------- #
    def optimize(self, x0):
        if self._objective is None:
            raise invalid_argument("no objective set")
        x0 = np.clip(np.asarray(x0, dtype=np.float64), self._lb, self._ub)
        if x0.shape != (self._n,):
            raise invalid_argument(
                f"x0 shape {x0.shape} != ({self._n},)"
            )

        self._numevals = 0
        self._t_start = time.time()
        self._best_x = x0.copy()
        self._best_f = np.inf
        self._pending_stop = None

        try:
            if self._algo_name in _AUGLAG:
                self._run_auglag(x0)
            elif self._algo_name in _MLSL:
                self._run_mlsl(x0)
            else:
                res = self._run_leaf(
                    self._algo_name, self._counting_objective, x0,
                    constraints=self._constraints,
                )
                code = self._convergence_code(res)
                self._last_result = code
        except _Stop as stop:
            self._last_result = stop.code

        self._last_value = float(self._best_f)
        return self._best_x.copy()

    # objective wrapper: counts evals, tracks the best point, enforces
    # maxeval / maxtime / stopval exactly once for the whole run
    def _counting_objective(self, x):
        if self._maxeval > 0 and self._numevals >= self._maxeval:
            raise _Stop(MAXEVAL_REACHED)
        if self._maxtime > 0 and time.time() - self._t_start > self._maxtime:
            raise _Stop(MAXTIME_REACHED)
        self._numevals += 1
        val = float(self._objective(np.asarray(x, np.float64), _EMPTY_GRAD))
        if np.isfinite(val) and val < self._best_f and self._feasible(x):
            self._best_f = val
            self._best_x = np.asarray(x, np.float64).copy()
        if self._stopval is not None and val <= self._stopval:
            raise _Stop(STOPVAL_REACHED)
        return val

    def _feasible(self, x, tol=1e-8):
        x = np.asarray(x, np.float64)
        for fn, ctol in self._constraints:
            if float(fn(x, _EMPTY_GRAD)) > max(ctol, tol):
                return False
        return True

    def _convergence_code(self, res):
        if not getattr(res, "success", True):
            # hitting scipy's own iteration cap is MAXEVAL-like
            return MAXEVAL_REACHED if self._maxeval > 0 else FAILURE
        if self._ftol_abs is not None or self._ftol_rel is not None:
            return FTOL_REACHED
        if self._xtol_abs is not None or self._xtol_rel is not None:
            return XTOL_REACHED
        return SUCCESS

    # map one leaf (non-multi-start) nlopt algorithm to a scipy call; the
    # counting wrapper enforces budgets, so scipy's caps are set loose
    def _run_leaf(self, name, objective, x0, constraints=()):
        bounds = spo.Bounds(self._lb, self._ub)
        budget = self._maxeval if self._maxeval > 0 else 100000

        if name in ("LN_NELDERMEAD", "LN_SBPLX"):
            options = {"maxfev": 10 * budget}
            if self._ftol_abs is not None:
                options["fatol"] = self._ftol_abs
            if self._xtol_abs is not None:
                options["xatol"] = float(np.max(self._xtol_abs))
            elif self._xtol_rel is not None:
                options["xatol"] = self._xtol_rel
            if self._initial_step is not None:
                step = self._initial_step
                sim = np.vstack([x0] + [x0 + step[i] * np.eye(self._n)[i]
                                        for i in range(self._n)])
                options["initial_simplex"] = np.clip(sim, self._lb, self._ub)
            return spo.minimize(objective, x0, method="Nelder-Mead",
                                bounds=bounds, options=options)

        if name in ("LN_BOBYQA", "LN_PRAXIS", "LN_NEWUOA",
                    "LN_NEWUOA_BOUND"):
            # BOBYQA/NEWUOA are bound-constrained quadratic-model trust
            # region methods; scipy's COBYQA is the same algorithm family
            # (Powell's derivative-free trust region, same author
            # lineage) and, like nlopt's, stays local to x0
            span = np.where(np.isfinite(self._ub - self._lb),
                            self._ub - self._lb, 1.0)
            rhobeg = (float(np.max(self._initial_step))
                      if self._initial_step is not None
                      else 0.01 * float(np.min(span)))
            tol = self._xtol_rel if self._xtol_rel is not None else (
                self._ftol_abs if self._ftol_abs is not None else 1e-8
            )
            return spo.minimize(
                objective, x0, method="COBYQA", bounds=bounds,
                options={"maxfev": 10 * budget,
                         "initial_tr_radius": rhobeg,
                         "final_tr_radius": max(tol, 1e-10)},
            )

        if name == "LN_COBYLA":
            cons = [
                {"type": "ineq",
                 # nlopt feasible: fn <= 0; scipy feasible: fun >= 0
                 "fun": (lambda x, _fn=fn: -float(_fn(x, _EMPTY_GRAD)))}
                for fn, _tol in constraints
            ]
            tol = self._xtol_rel if self._xtol_rel is not None else (
                self._ftol_abs if self._ftol_abs is not None else 1e-8
            )
            # the initial trust radius matches nlopt COBYLA's default
            # initial step for a bounded problem (a fraction of the box
            # size), keeping the search local to x0 as nlopt's does;
            # scipy's COBYQA solves the same problem class
            # (derivative-free linear-constraint trust region) with far
            # better convergence per evaluation than its COBYLA port
            span = np.where(np.isfinite(self._ub - self._lb),
                            self._ub - self._lb, 1.0)
            rhobeg = (float(np.max(self._initial_step))
                      if self._initial_step is not None
                      else 0.01 * float(np.min(span)))
            return spo.minimize(
                objective, x0, method="COBYQA", constraints=cons,
                bounds=bounds,
                options={"maxfev": 10 * budget,
                         "initial_tr_radius": rhobeg,
                         "final_tr_radius": max(tol, 1e-10)},
            )

        if name.startswith("GN_DIRECT") or name.startswith("GN_ORIG"):
            # scipy's DIRECT is C-implemented and cannot propagate the
            # counting wrapper's _Stop through its callback (SystemError)
            # -> enforce budgets with a non-raising wrapper + scipy's own
            # maxfun, and re-raise the deferred stop afterwards
            def soft(x):
                try:
                    return objective(x)
                except _Stop as stop:
                    self._pending_stop = stop.code
                    return float(self._best_f) if np.isfinite(
                        self._best_f
                    ) else 1e300

            res = spo.direct(
                soft, bounds,
                maxfun=budget, maxiter=10 * budget,
                locally_biased="_L" in name,
                f_min_rtol=(self._ftol_rel if self._ftol_rel is not None
                            else 1e-12),
            )
            if self._pending_stop is not None:
                raise _Stop(self._pending_stop)
            return res

        if name in ("GN_CRS2_LM", "GN_ESCH", "GN_ISRES"):
            cons = ()
            if constraints:
                cons = tuple(
                    spo.NonlinearConstraint(
                        (lambda x, _fn=fn: -float(_fn(x, _EMPTY_GRAD))),
                        0.0, np.inf,
                    )
                    for fn, _tol in constraints
                )
            popsize = (max(2, self._population // max(self._n, 1))
                       if self._population else 15)
            maxiter = max(1, budget // max(popsize * self._n, 1))
            return spo.differential_evolution(
                objective, bounds, maxiter=maxiter, popsize=popsize,
                seed=int(_RNG.integers(2**31 - 1)), polish=False,
                constraints=cons, tol=(self._ftol_rel or 0.01),
            )

        raise invalid_argument(f"unsupported leaf algorithm {name}")

    # MLSL: multi-start over the subsidiary local optimizer; LDS
    # variants draw starts from a scrambled Sobol sequence
    def _run_mlsl(self, x0):
        local = self._local
        local_name = local._algo_name if local is not None else (
            "LN_NELDERMEAD"
        )
        span = np.where(np.isfinite(self._ub - self._lb),
                        self._ub - self._lb, 1.0)
        lo = np.where(np.isfinite(self._lb), self._lb, x0 - 0.5 * span)

        n_starts = 64
        if self._maxeval > 0:
            per_local = (local._maxeval if local is not None
                         and local._maxeval > 0 else 10 * self._n)
            n_starts = max(1, self._maxeval // max(per_local, 1) + 1)
        if "LDS" in self._algo_name:
            from scipy.stats import qmc

            sampler = qmc.Sobol(
                d=self._n, scramble=True,
                seed=int(_RNG.integers(2**31 - 1)),
            )
            unit = sampler.random(n_starts)
        else:
            unit = _RNG.random((n_starts, self._n))
        starts = np.vstack([x0, lo + unit * span])

        for xs in starts:
            # each local solve runs with the LOCAL optimizer's algorithm
            # and tolerances but THIS optimizer's counting wrapper, so
            # the global maxeval/maxtime budget holds across restarts
            runner = local if local is not None else self
            res = runner._run_leaf(
                local_name, self._counting_objective,
                np.clip(xs, self._lb, self._ub),
            )
            del res
        self._last_result = (MAXEVAL_REACHED if self._maxeval > 0
                             else SUCCESS)

    # AUGLAG: textbook augmented-Lagrangian outer loop (inequality
    # multipliers) around the subsidiary local optimizer
    def _run_auglag(self, x0):
        local = self._local
        local_name = local._algo_name if local is not None else (
            "LN_NELDERMEAD"
        )
        cons = [fn for fn, _tol in self._constraints]
        if not cons:
            res = (local if local is not None else self)._run_leaf(
                local_name, self._counting_objective, x0,
            )
            self._last_result = self._convergence_code(res)
            return

        mu = 1.0
        lam = np.zeros(len(cons))
        xk = x0.copy()
        ctol = 1e-6
        prev_f = np.inf
        ftol = self._ftol_abs if self._ftol_abs is not None else 1e-10

        for _outer in range(50):
            def penalized(x, _mu=mu, _lam=lam.copy()):
                f = self._counting_objective(x)
                pen = 0.0
                for j, fn in enumerate(cons):
                    cj = float(fn(np.asarray(x, np.float64), _EMPTY_GRAD))
                    t = max(0.0, _lam[j] + _mu * cj)
                    pen += (t * t - _lam[j] * _lam[j]) / (2.0 * _mu)
                return f + pen

            runner = local if local is not None else self
            res = runner._run_leaf(local_name, penalized, xk)
            xk = np.clip(np.asarray(res.x, np.float64),
                         self._lb, self._ub)
            cvals = np.array(
                [float(fn(xk, _EMPTY_GRAD)) for fn in cons]
            )
            lam = np.maximum(0.0, lam + mu * cvals)
            fk = float(self._objective(xk, _EMPTY_GRAD))
            if (np.all(cvals <= ctol)
                    and abs(prev_f - fk) <= max(ftol, 1e-12)):
                # converged feasible: make sure the reported optimum is
                # the feasible solution, not an infeasible best-tracker hit
                self._best_x = xk.copy()
                self._best_f = fk
                self._last_result = FTOL_REACHED
                return
            prev_f = fk
            mu *= 4.0

        self._best_x = xk.copy()
        self._best_f = float(self._objective(xk, _EMPTY_GRAD))
        self._last_result = (MAXEVAL_REACHED if self._maxeval > 0
                             else SUCCESS)
