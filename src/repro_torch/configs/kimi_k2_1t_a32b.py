"""Kimi K2 — trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2].

GQA kv=8 (not MLA); 1 shared expert per DeepSeek-style MoE.  bf16
params, as the reference's config has them (AdamW's fp32 state for 1T
params would be ~8 TB).
"""
import dataclasses

from repro_torch.configs.base import MoEConfig, TransformerConfig

CONFIG = TransformerConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab=163840,
    moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048, n_shared=1),
    param_dtype="bfloat16",
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="kimi-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=64, vocab=256, param_dtype="float32",
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=64, n_shared=1))
