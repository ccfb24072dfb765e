"""
K-fold selection (counterpart of ``pisa_tpu/stages/utils/kfold.py``;
reference ``pisa/stages/utils/kfold.py``): zeroes the weights of the events
outside the selected fold, optionally renormalizing by the number of
splits, and optionally saves the fold as the boolean ``kfold_mask``, which
``likelihood.generalized_llh_params`` reads.

The JAX stage takes the folds from scikit-learn's ``KFold``; the port
computes the same split in numpy (:func:`kfold_test_indices`), so it needs
no scikit-learn.
"""

from __future__ import annotations

import numpy as np

from pisa_tpu_torch import FTYPE
from pisa_tpu_torch.core.stage import Stage

__all__ = ["kfold", "kfold_test_indices", "init_test"]


def kfold_test_indices(n, n_splits, select_split, shuffle=False, seed=None):
    """The test indices of fold `select_split` of `n` samples in
    `n_splits` folds, in ascending order, as
    ``sklearn.model_selection.KFold(n_splits, shuffle=shuffle,
    random_state=seed).split`` gives them: the indices shuffled in place by
    ``np.random.RandomState(seed)`` (scikit-learn's ``check_random_state``;
    numpy's global state for seed None) when `shuffle`, then cut into
    consecutive folds, the first ``n % n_splits`` one longer."""
    if n_splits < 2:
        raise ValueError(f"k-fold needs at least 2 splits, got {n_splits}")
    if not 0 <= select_split < n_splits:
        raise ValueError(f"select_split {select_split} is not one of the"
                         f" {n_splits} folds")
    if n_splits > n:
        raise ValueError(f"cannot have n_splits={n_splits} greater than the"
                         f" number of samples: n_samples={n}")
    if not shuffle and seed is not None:
        raise ValueError(
            "Setting a random_state has no effect since shuffle is False."
            " You should leave random_state to its default (None), or set"
            " shuffle=True.")
    indices = np.arange(n)
    if shuffle:
        state = (np.random.mtrand._rand if seed is None
                 else np.random.RandomState(seed))
        state.shuffle(indices)
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[:n % n_splits] += 1
    start = int(sizes[:select_split].sum())
    return np.sort(indices[start:start + sizes[select_split]])


class kfold(Stage):  # noqa: N801
    """Parameters: n_splits, select_split, seed, renormalize, shuffle,
    save_mask. Events calc mode."""

    def __init__(self, n_splits, select_split=0, seed=None,
                 renormalize=False, shuffle=False, save_mask=False,
                 **std_kwargs):
        super().__init__(
            expected_params=(),
            expected_container_keys=("weights",),
            **std_kwargs,
        )
        self.n_splits = int(n_splits)
        self.select_split = int(select_split)
        self.seed = None if seed is None else int(seed)
        self.renormalize = bool(renormalize)
        self.shuffle = bool(shuffle)
        self.save_mask = save_mask

    def setup_function(self):
        for container in self.data:
            select_idx = kfold_test_indices(
                container.size, self.n_splits, self.select_split,
                shuffle=self.shuffle, seed=self.seed)
            fold = np.zeros(container.size, dtype=FTYPE)
            fold[select_idx] = self.n_splits if self.renormalize else 1.0
            container["fold_weight"] = fold
            if self.save_mask:
                mask = np.zeros(container.size, dtype=bool)
                mask[select_idx] = True
                container["kfold_mask"] = mask

    def apply_function(self):
        for container in self.data:
            container["weights"] = (
                container["weights"] * container["fold_weight"])


def init_test(**param_kwargs):
    """Instantiation example."""
    return kfold(n_splits=2, calc_mode="events")
