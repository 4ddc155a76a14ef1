"""Batch-regime dispatch — the paper's §4 split between the small- and
large-batch procedures (the reference's ``ann/dispatch.py::regime_for``;
probe calibration comes in a later slice)."""
from __future__ import annotations


def regime_for(cfg, batch: int, *, threshold: float | None = None,
               n_delta: int = 0) -> str:
    """``"small"`` or ``"large"`` for a batch of ``batch`` queries: small
    while the search population ``batch * t0`` stays under
    ``4 * threshold`` (``cfg.small_batch_threshold`` by default).
    ``n_delta`` live delta-shard rows add ``n_delta / hop_width``
    hop-equivalents per query (0 for a frozen index)."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    thr = cfg.small_batch_threshold if threshold is None else threshold
    pop = batch * cfg.small_t0
    if n_delta > 0:
        pop += batch * (n_delta // max(1, cfg.hop_width))
    return "small" if pop < thr * 4 else "large"
