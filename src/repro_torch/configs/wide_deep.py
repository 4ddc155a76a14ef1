"""Wide & Deep — 40 sparse fields, dim 32, 1024-512-256 MLP [arXiv:1606.07792]."""
import dataclasses

from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(name="wide-deep")


def reduced():
    return dataclasses.replace(
        CONFIG, name="wide-deep-reduced", n_sparse=6, embed_dim=8,
        mlp=(32, 16), vocab_sizes=tuple([1000] * 2 + [100] * 4),
        multi_hot_fields=(0,), bag_size=3, wide_hash_buckets=1000)
