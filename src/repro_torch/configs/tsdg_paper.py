"""The paper's own system — TSDG index + GPU-style search procedures."""
import dataclasses

from repro_torch.configs.base import ANNConfig

CONFIG = ANNConfig()


def reduced():
    return dataclasses.replace(
        CONFIG, name="tsdg-reduced", k_graph=8, max_degree=8, small_t0=4,
        small_hops=4, large_ef=16, large_hops=32, n_seeds=8, hop_width=8,
        queue_segments=4, segment_size=8, visited_segments=4)
