"""Gemma3-27B — dense, 5:1 local:global attention, 128k context [hf:google/gemma-3]."""
import dataclasses

from repro_torch.configs.base import TransformerConfig

CONFIG = TransformerConfig(
    name="gemma3-27b",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
    d_ff=21504, vocab=262144,
    head_dim=128,
    local_global_ratio=5, local_window=1024,
    tie_embeddings=True,
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="gemma3-reduced", n_layers=6, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, head_dim=16, local_window=16)
