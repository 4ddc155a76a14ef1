"""OLMoE-1B-7B — 64-expert top-8 MoE LM [arXiv:2409.02060]."""
import dataclasses

from repro_torch.configs.base import MoEConfig, TransformerConfig

CONFIG = TransformerConfig(
    name="olmoe-1b-7b",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab=50304,
    moe=MoEConfig(n_experts=64, top_k=8, d_expert=1024),
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="olmoe-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=128))
