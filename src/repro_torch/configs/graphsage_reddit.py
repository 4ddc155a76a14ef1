"""GraphSAGE (Reddit) — 2 layers, mean aggregator, 25-10 fanout [arXiv:1706.02216]."""
import dataclasses

from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="graphsage-reddit", kind="graphsage", n_layers=2, d_hidden=128,
    aggregator="mean", sample_sizes=(25, 10),
)


def reduced():
    return dataclasses.replace(CONFIG, name="graphsage-reduced", n_layers=2,
                               d_hidden=16, sample_sizes=(5, 3))
