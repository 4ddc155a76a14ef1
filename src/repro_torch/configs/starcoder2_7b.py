"""StarCoder2-7B — dense, GQA kv=4, RoPE, 4k sliding window [arXiv:2402.19173]."""
import dataclasses

from repro_torch.configs.base import TransformerConfig

CONFIG = TransformerConfig(
    name="starcoder2-7b",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab=49152,
    window=4096,
    gated_ffn=False,  # starcoder2 uses a plain GELU MLP (c_fc/c_proj)
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="starcoder2-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, window=32)
