"""
Freeze the errors (counterpart of ``pisa_tpu/stages/utils/fix_error.py``;
reference ``pisa/stages/utils/fix_error.py``): the errors of the first
evaluation after set-up are kept, and every apply writes them back.

The JAX stage keeps the snapshot in its compute, which the eager pipeline
runs once (the stage has no params, so its params hash never changes) but
a compiled template runs at every evaluation: there the JAX package's
errors follow the parameters. The port freezes them on both routes: the
snapshot (detached, so no gradient flows through it) lives on the stage,
is taken at the first compute after set-up and is kept by every later
one, a compiled template's included.
"""

from __future__ import annotations

from pisa_tpu_torch.core.stage import Stage

__all__ = ["fix_error", "init_test"]


class fix_error(Stage):  # noqa: N801
    """No params."""

    def __init__(self, **std_kwargs):
        super().__init__(
            expected_params=(),
            expected_container_keys=("errors",),
            **std_kwargs,
        )
        #: container name -> the frozen errors (None: not taken yet)
        self.frozen_errors = None

    def setup_function(self):
        self.frozen_errors = None

    def compute_function(self):
        if self.frozen_errors is not None:
            return
        frozen = {}
        for container in self.data:
            errors = container["errors"].detach()
            if container.lanes is not None:
                errors = errors[0]
            frozen[container.name] = errors.clone()
        self.frozen_errors = frozen

    def apply_function(self):
        for container in self.data:
            errors = self.frozen_errors[container.name]
            if container.lanes is not None:
                errors = errors.expand((container.lanes,) + errors.shape)
            container["errors"] = errors


def init_test(**param_kwargs):
    """Instantiation example."""
    return fix_error()
