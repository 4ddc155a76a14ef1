"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  ``launch_counts()`` / ``reset_launch_counts()`` read and zero the
launch counter of each kernel body (the only global state of the package),
which its wrapper bumps where it launches; a CUDA graph's replay adds the
launches recorded at its capture (``_build.recording`` /
``_build.replayed``)."""
from __future__ import annotations

from repro_torch.kernels._build import LAUNCHES


def launch_counts() -> dict:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
