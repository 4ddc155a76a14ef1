"""The arithmetic of the port's two attention bodies
(``repro_torch.kernels.flash_attention``), on the CPU, against the JAX
reference (``repro.kernels.ops.flash_attention`` with ``use_pallas=False``).

The CUDA bodies run only on the card (``tests/test_torch_cuda.py``); here
their arithmetic is held to the reference on the same numpy inputs:

* ``path``: which body a shape takes;
* ``split_plain``: the split-KV body's partials per planned chunk and
  their combine, within 1e-5 * (P @ |V|) of the float32 reference;
* the tile body's operand splits, emulated in float64 around the products:
  P as bf16 hi + lo for bf16 inputs, 3xTF32 for float32 inputs, each
  within 1e-5 * (P @ |V|) (plus one rounding of a bf16 output,
  2^-8 * |out|), and the single roundings they replace outside it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

torch.set_num_threads(1)


@functools.partial(jax.jit, static_argnames=("window", "q_offset"))
def _jattn(q, k, v, window, q_offset):
    return jops.flash_attention(q, k, v, window=window, q_offset=q_offset,
                                use_pallas=False)


def _case(seed, B, Sq, Skv, H, KV, hd):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, h, hd)).astype(np.float32)
            for S, h in ((Sq, H), (Skv, KV), (Skv, KV))]


def _want(q, k, v, window=0, q_offset=0):
    """The reference in float32, and the weights P @ |V| of the bound."""
    want = np.asarray(_jattn(*map(jnp.asarray, (q, k, v)), window, q_offset))
    weight = ref.attention_ref(*map(torch.from_numpy, (q, k, np.abs(v))),
                               window=window, q_offset=q_offset).numpy()
    return want, weight


@pytest.mark.parametrize("B,Sq,Skv,H,KV,expect", [
    (8, 1, 32768, 16, 16, "split"),     # OLMo-1B decode
    (8, 1, 32768, 32, 1, "split"),      # a decode step always splits
    (1, 2, 512, 2, 2, "split"),         # 2 rows a KV head: the threshold
    (1, 3, 512, 2, 2, "tile"),          # 3 rows
    (1, 2, 512, 4, 2, "tile"),          # 2 queries of 2 heads: 4 rows
    (1, 4096, 4096, 16, 16, "tile")])   # OLMo-1B prefill
def test_path_takes_split_up_to_the_threshold(B, Sq, Skv, H, KV, expect):
    assert fa.path(B, Sq, Skv, H, KV, 128, torch.bfloat16) == expect


def test_split_plan_fills_the_card_and_covers_the_keys():
    """OLMo-1B's decode (8 x 16 KV heads) alone gives 128 CTAs; the plan
    cuts 32,768 keys into chunks for about 16 CTAs an SM, and its chunks
    cover the visible keys exactly once."""
    p = fa.split_plan(8, 1, 32768, 16, 16, q_offset=32767)
    assert p.nq == 1 and 8 * 16 * p.chunks >= 132 * 8
    assert p.chunk >= fa.MIN_CHUNK and p.chunk % fa.CHUNK_ALIGN == 0
    assert p.lo == 0 and (p.chunks - 1) * p.chunk < 32768 <= p.chunks * p.chunk
    w = fa.split_plan(8, 1, 32768, 32, 16, window=1024, q_offset=32767)
    assert w.nq == 2 and w.lo == 32768 - 1024
    assert (w.chunks - 1) * w.chunk < 1024 <= w.chunks * w.chunk


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,window,q_offset,chunk", [
    (2, 1, 300, 4, 2, 32, 0, 299, 64),     # decode, GQA, a ragged chunk
    (1, 4, 200, 4, 2, 24, 16, 150, 16),    # window: chunks empty for rows
    (1, 8, 90, 2, 2, 16, 3, 40, 8),        # window 3, chunks of 8
    (2, 3, 130, 6, 2, 8, 0, 100, 32)])     # an offset, G = 3
def test_split_plain_matches_reference(B, Sq, Skv, H, KV, hd, window,
                                       q_offset, chunk):
    """The split body's arithmetic: chunks that some (or every) row does
    not see weigh 0, GQA reads KV head h / G."""
    q, k, v = _case(B * 1000 + Skv, B, Sq, Skv, H, KV, hd)
    plan = fa.split_plan(B, Sq, Skv, H, KV, window=window,
                         q_offset=q_offset, chunk=chunk)
    assert plan.chunks > 1
    want, weight = _want(q, k, v, window, q_offset)
    got = fa.split_plain(*map(torch.from_numpy, (q, k, v)), window=window,
                         q_offset=q_offset, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (B, Sq, H, hd)
    assert (np.abs(got.numpy() - want) <= 1e-5 * weight).all()
    bf = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    got = fa.split_plain(*bf, window=window, q_offset=q_offset, chunk=chunk)
    want, weight = _want(*(a.float().numpy() for a in bf), window, q_offset)
    assert got.dtype == torch.bfloat16
    assert (np.abs(got.float().numpy() - want)
            <= 1e-5 * weight + 2.0 ** -8 * np.abs(want)).all()


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().double() \
        .numpy()


def _tf32(x):
    """cvt.rna.tf32.f32: the float32 bits rounded to 10 mantissa bits,
    ties away from zero."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32).astype(np.float64)


def _split(x, rnd):
    hi = rnd(x)
    return hi, rnd(np.asarray(x, np.float32) - hi.astype(np.float32))


def _softmax_parts(s, window=0):
    """Masked causal p = exp(s - max) and its row sums, float64 [H, S, S]."""
    S = s.shape[-1]
    i, j = np.arange(S)[:, None], np.arange(S)[None, :]
    mask = (j <= i) & ((j > i - window) if window > 0 else True)
    s = np.where(mask, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return p, p.sum(-1, keepdims=True)


def test_tile_operand_splits_hold_the_tolerance():
    """S = 256 causal, 2 q heads on 1 KV head of 64.  bf16 inputs: S from
    the exact bf16 products, P @ V with P = hi + lo (two bf16 products)
    holds 1e-5 * (P @ |V|) + 2^-8 * |out| after the output's rounding; one
    bf16 rounding of P does not.  float32 inputs: 3xTF32 on both products
    holds 1e-5 * (P @ |V|); one TF32 rounding of P and V does not."""
    S, H, hd = 256, 2, 64
    q, k, v = _case(7, 1, S, S, H, 1, hd)
    scale = hd ** -0.5
    qh = q[0].transpose(1, 0, 2)          # [H, S, hd]
    k0, v0 = k[0, :, 0], v[0, :, 0]       # [S, hd], the one KV head

    # bf16 inputs
    qb, kb, vb = _bf16(qh), _bf16(k0), _bf16(v0)
    want, weight = _want(*(np.asarray(_bf16(a), np.float32)
                           for a in (q, k, v)))
    want, weight = want[0].transpose(1, 0, 2), weight[0].transpose(1, 0, 2)
    tol = 1e-5 * weight + 2.0 ** -8 * np.abs(want)
    p, l_sum = _softmax_parts(qb @ kb.T * scale)
    p_hi, p_lo = _split(p, _bf16)
    split = _bf16((p_hi @ vb + p_lo @ vb) / l_sum)
    once = _bf16((p_hi @ vb) / l_sum)
    assert (np.abs(split - want) <= tol).all()
    assert (np.abs(once - want) / tol).max() > 4

    # float32 inputs: q scaled in float32 before the split
    want, weight = _want(q, k, v)
    want, weight = want[0].transpose(1, 0, 2), weight[0].transpose(1, 0, 2)
    tol = 1e-5 * weight
    q_hi, q_lo = _split(qh * np.float32(scale), _tf32)
    k_hi, k_lo = _split(k0, _tf32)
    v_hi, v_lo = _split(v0, _tf32)
    s = q_hi @ k_hi.T + q_hi @ k_lo.T + q_lo @ k_hi.T
    p, l_sum = _softmax_parts(s)
    p_hi, p_lo = _split(p, _tf32)
    split = (p_hi @ v_hi + p_hi @ v_lo + p_lo @ v_hi) / l_sum
    once = (p_hi @ v_hi) / l_sum
    assert (np.abs(split - want) <= tol).all()
    assert (np.abs(once - want) / tol).max() > 4
