"""GIN (TU benchmarks) — 5 layers, sum aggregator, learnable eps [arXiv:1810.00826]."""
import dataclasses

from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="gin-tu", kind="gin", n_layers=5, d_hidden=64,
    aggregator="sum", learnable_eps=True,
)


def reduced():
    return dataclasses.replace(CONFIG, name="gin-reduced", n_layers=2,
                               d_hidden=16)
