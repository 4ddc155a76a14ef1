"""Optimizers, schedules, clipping, gradient compression: the port's copy
of the reference's ``optim/``.  Parameter trees are nested dicts of
tensors in the reference's layout (stacked ``blocks`` leaves [L, ...]),
walked in sorted key order, the order of ``jax.tree.flatten``."""
from repro_torch.optim import adafactor, adamw  # noqa: F401
from repro_torch.optim.api import OptimizerConfig, make_optimizer  # noqa: F401
