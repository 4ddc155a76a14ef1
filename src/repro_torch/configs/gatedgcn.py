"""GatedGCN — 16 layers, gated edge aggregation [arXiv:2003.00982]."""
import dataclasses

from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="gatedgcn", kind="gatedgcn", n_layers=16, d_hidden=70,
    aggregator="gated",
)


def reduced():
    return dataclasses.replace(CONFIG, name="gatedgcn-reduced", n_layers=2,
                               d_hidden=16)
