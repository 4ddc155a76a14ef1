"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  ``launch_counts()`` / ``reset_launch_counts()`` read and zero the
wrappers' launch counters (the only global state of the package)."""
from __future__ import annotations

from repro_torch.kernels.l2dist import gather_distances
from repro_torch.kernels.topk import rank_merge
from repro_torch.kernels.visited import visited_filter

KERNELS = {"gather_distances": gather_distances, "rank_merge": rank_merge,
           "visited_filter": visited_filter}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
