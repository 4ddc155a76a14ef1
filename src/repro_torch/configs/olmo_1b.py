"""OLMo-1B — dense, non-parametric LayerNorm [arXiv:2402.00838]."""
import dataclasses

from repro_torch.configs.base import TransformerConfig

CONFIG = TransformerConfig(
    name="olmo-1b",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=50304,
    nonparametric_ln=True,
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="olmo-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256)
