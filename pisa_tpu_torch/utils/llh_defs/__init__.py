"""Generalized Poisson-gamma likelihood definitions (arXiv:1902.08831);
counterpart of ``pisa_tpu/utils/llh_defs``."""

from pisa_tpu_torch.utils.llh_defs.poisson import (
    approximate_poisson_normal,
    generalized_pg_llh,
    generalized_pg_log_mixture,
)

__all__ = [
    "approximate_poisson_normal",
    "generalized_pg_llh",
    "generalized_pg_log_mixture",
]
