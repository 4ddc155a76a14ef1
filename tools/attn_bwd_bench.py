"""``flash_attention_bwd`` on the card, at ``chip_smoke.py``'s phase 17 (a)
shapes: the compiled bodies (registers, spilled bytes, HMMA), then each
variant's err/tol of dq, dk and dv against the float64 oracle
(``chip_smoke.bwd_over_tol``) and, at OLMo-1B's layer, its ms beside
SDPA's backward, the variants timed in turns (A B B A).

Variants: ``kernel`` (``csrc/flash_attention_bwd.cu`` as the port builds
it) and, with ``--parent``, another ``flash_attention_bwd.cu`` with the
same C entry points (an earlier design, say), built by ``nvcc`` beside the
port's libraries and called through the port's wrapper.

    PYTHONPATH=src python tools/attn_bwd_bench.py [--parent FILE.cu]

One JSON object a case, then one with every row, on the last line.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)

import chip_smoke as CS  # noqa: E402


def build(src: str):
    """Another ``flash_attention_bwd.cu`` built by nvcc and loaded."""
    from repro_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "libbwd_bench_parent.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS,
                           f"-I{_build.CSRC}", "-o", str(out), src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}")
    return typed(ctypes.CDLL(str(out)))


def typed(lib):
    """The backward's two C entry points typed as the wrapper types
    them."""
    i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    lib.repro_flash_bwd_dq.argtypes = [p] * 7 + [i] * 8 + [f, i, p]
    lib.repro_flash_bwd_dkv.argtypes = [p] * 8 + [i] * 8 + [f, i, p]
    for fn in (lib.repro_flash_bwd_dq, lib.repro_flash_bwd_dkv):
        fn.restype = i
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None,
                    help="another flash_attention_bwd.cu to time beside")
    args = ap.parse_args()

    import torch

    from repro_torch.kernels import _build, flash_attention as FA, ref

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(CS.card_name(), flush=True)
    bodies = FA.bwd_body_attributes()
    hmma = _build.hmma_counts("flash_attention_bwd") or {}
    print(json.dumps({"bodies": bodies, "hmma": hmma}), flush=True)

    libs = {"kernel": FA._bwd_lib()}
    if args.parent:
        libs["parent"] = build(os.path.abspath(args.parent))
    order = list(libs)
    real_lib = FA._bwd_lib

    def run(name, *a, **kw):
        FA._bwd_lib = lambda: libs[name]
        try:
            return FA.flash_attention_bwd(*a, **kw)
        finally:
            FA._bwd_lib = real_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    for label, B, S, H, KV, hd, window, dtypes, timed in CS.BWD_CASES:
        for dtype in dtypes:
            dt = getattr(torch, dtype)
            q, dout = (torch.randn((B, S, H, hd), generator=gen,
                                   device=dev).to(dt) for _ in range(2))
            k, v = (torch.randn((B, S, KV, hd), generator=gen,
                                device=dev).to(dt) for _ in range(2))
            kw = dict(window=window)
            leaves = [t.double().requires_grad_() for t in (q, k, v)]
            ref64 = torch.autograd.grad(ref.attention_ref(*leaves, **kw),
                                        leaves, dout.double())
            del leaves
            plain = FA.flash_attention_bwd_plain(
                q.float(), k.float(), v.float(), dout.float(), **kw)
            err_plain = [float((p.double() - r).abs().max())
                         for p, r in zip(plain, ref64)]
            del plain
            r = dict(shape=f"{label} [{B}, {S}, {H} over {KV} x {hd}] "
                     f"{'window ' + str(window) if window else 'causal'} "
                     f"{dtype}", err_plain=err_plain)
            for name in order:
                with _build.recording():
                    got = run(name, q, k, v, dout, **kw)
                torch.cuda.synchronize()
                r[f"{name}_err_over_tol"] = [
                    CS.bwd_over_tol(g, w, e)
                    for g, w, e in zip(got, ref64, err_plain)]
                del got
            del ref64
            torch.cuda.empty_cache()
            if timed:
                ms = {name: [] for name in order}
                with _build.recording():
                    for name in order + order[::-1]:
                        ms[name].append(CS.cuda_ms(
                            lambda: run(name, q, k, v, dout, **kw), 3))
                r["ms"] = ms
                r["sdpa_bwd_ms"] = CS.cuda_ms(
                    CS.sdpa_bwd(q, k, v, dout, window), 5)
                pairs = CS.visible_pairs(S, S, window, 0) * B * H
                r["bound_ms"] = CS.bound(
                    (3 * B * S * H + 4 * B * S * KV) * hd * q.element_size(),
                    10 * hd * pairs,
                    CS.BF16_OPS_PER_S if dt == torch.bfloat16
                    else CS.FP32_OPS_PER_S)[0]
            rows.append(r)
            print(json.dumps(r), flush=True)
    print(json.dumps({"card": CS.card_name(), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
