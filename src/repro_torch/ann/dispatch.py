"""Batch-regime dispatch — the paper's §4 split between the small- and
large-batch procedures (the reference's ``ann/dispatch.py``).

:func:`regime_for` is the one home of the rule.  With
``cfg.regime_calibration="probe"`` the engine replaces the static
threshold by one fitted from timed probe batches (:func:`calibrate`, the
paper's per-GPU fit): both procedures are timed through the plane's own
callables (CUDA graph replays on the card) at two batch sizes, a linear
latency model is fitted per regime, and the batch where they cross
becomes the threshold.
"""
from __future__ import annotations

import dataclasses
import os
import time

import torch


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


@dataclasses.dataclass(frozen=True)
class Calibration:
    """A fitted regime split (see :func:`calibrate`).

    ``threshold`` drops into the ``B·t0 < 4·threshold`` rule of
    :func:`regime_for`.  ``a``/``b``/``cores``/``d`` give the same point in
    the paper's ``(a·cores + b) / d`` form; probes from one device make the
    fit degenerate (``b = 0``, ``a = B*·d/cores``)."""

    threshold: float
    crossover_batch: float     # B*: the batch where the procedures tie
    a: float
    b: float
    cores: int
    d: int
    degenerate: bool           # probes could not order the procedures
    probes: dict               # {regime: [(batch, seconds_per_call), ...]}

    def to_manifest(self) -> dict:
        out = dataclasses.asdict(self)
        out["probes"] = {kind: [[int(B), float(t)] for B, t in rows]
                         for kind, rows in self.probes.items()}
        return out

    @classmethod
    def from_manifest(cls, d: dict) -> "Calibration":
        d = dict(d)
        d["probes"] = {kind: [(int(B), float(t)) for B, t in rows]
                       for kind, rows in d.get("probes", {}).items()}
        return cls(**d)


def _device_cores(device) -> int:
    """The card's SM count, or the host's cores on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device)
                   .multi_processor_count)
    return int(os.cpu_count() or 1)


def calibrate(plane, cfg, *, k: int = 10, probe_batches=(4, 32),
              repeats: int = 3) -> Calibration:
    """Fit the regime threshold from timed probe batches on ``plane``.

    Each procedure's callable (``plane.compile``) is made at each probe
    batch, called once, then timed ``repeats`` times (the best counts),
    the card synchronised before and after each timed call.  Per regime
    ``t(B) = α + β·B``; the crossover ``B* = (α_large − α_small) /
    (β_small − β_large)`` gives ``threshold = B*·t0 / 4``.  When the small
    procedure never loses per query the fit is degenerate and keeps the
    static threshold."""
    d = int(plane.X.shape[1])
    mult = plane.batch_multiple()
    device = plane.device

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    times: dict = {"small": [], "large": []}
    for kind in ("small", "large"):
        for B in probe_batches:
            Br = -(-int(B) // mult) * mult
            exe = plane.compile(kind, Br, k)
            Q = torch.zeros((Br, d), dtype=torch.float32, device=device)
            exe(Q)
            best = float("inf")
            for _ in range(repeats):
                sync()
                t0 = time.perf_counter()
                exe(Q)
                sync()
                best = min(best, time.perf_counter() - t0)
            times[kind].append((Br, best))

    def _fit(rows):
        (B1, t1), (B2, t2) = rows[0], rows[-1]
        if B2 == B1:
            return t1, 0.0
        beta = (t2 - t1) / (B2 - B1)
        return t1 - beta * B1, beta

    a_s, b_s = _fit(times["small"])
    a_l, b_l = _fit(times["large"])
    cores = _device_cores(device)
    if b_s <= b_l:  # small never loses per query on these probes
        return Calibration(
            threshold=float(cfg.small_batch_threshold),
            crossover_batch=float("inf"), a=0.0, b=0.0, cores=cores, d=d,
            degenerate=True, probes=times)
    b_star = (a_l - a_s) / (b_s - b_l)
    b_star = min(max(b_star, 1.0), 1e7)
    threshold = b_star * cfg.small_t0 / 4.0
    return Calibration(
        threshold=float(threshold), crossover_batch=float(b_star),
        a=float(b_star * d / cores), b=0.0, cores=cores, d=d,
        degenerate=False, probes=times)
