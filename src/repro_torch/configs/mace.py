"""MACE — higher-order E(3)-equivariant message passing [arXiv:2206.07697]."""
import dataclasses

from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="mace", kind="mace", n_layers=2, d_hidden=128,
    l_max=2, correlation_order=3, n_rbf=8,
)


def reduced():
    return dataclasses.replace(CONFIG, name="mace-reduced", n_layers=1,
                               d_hidden=8, l_max=1, correlation_order=2,
                               n_rbf=4)
