"""Time variants of ``csrc/embedding_bag.cu``'s vector body on the card.

Each variant is the source with one design choice changed, built by
``nvcc`` beside the package's own build and called through the same C
entry point; every variant's output must equal the plain version bit
for bit.  The variants:

* ``as built``: the source unchanged;
* ``16 rows, 2 CTAs`` / ``10 rows, 3 CTAs`` / ``12 rows, 2 CTAs``: another
  batch of row loads a lane issues before its adds, and another count of
  CTAs an SM the vector bodies ask registers for (``vector_ctas``);
* ``L1 allocate``: the row loads without the ``L1::no_allocate`` hint;
* ``full grid``: one CTA a bag group instead of the persistent grid.

Cases: phase 9's uniform ids (the 10,000,000 x 32 table, bag 10, B = 512
and 65,536, fp32 and bf16) and phase 15's skewed ids (``CTRStream``'s
first bag field of full-size wide_deep, B = 262,144).  Device ms (the
calls queued ahead, the least of 3 means of 20), each variant twice in
the order A B ... B A, with the lane route (the earlier design) beside
them; registers and spilled bytes from ``-Xptxas -v``.

    PYTHONPATH=src python tools/bag_variants.py
"""
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
import chip_smoke as S  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data.recsys import CTRStream  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import embedding_bag as EB  # noqa: E402

BATCH = "constexpr int kBatch = 8;"
CTAS = "return G == 1 ? 2 : (G == 2 ? 3 : 4);"
HINT = "ld.global.nc.L1::no_allocate.v4.u32"
GRID = "groups < resident ? groups : resident"
VARIANTS = {
    "as built": (),
    "16 rows, 2 CTAs": ((BATCH, "constexpr int kBatch = 16;"),
                        (CTAS, "return G == 1 ? 1 : 2;")),
    "10 rows, 3 CTAs": ((BATCH, "constexpr int kBatch = 10;"),
                        (CTAS, "return G == 1 ? 1 : 3;")),
    "12 rows, 2 CTAs": ((BATCH, "constexpr int kBatch = 12;"),
                        (CTAS, "return G == 1 ? 1 : 2;")),
    "L1 allocate": ((HINT, "ld.global.nc.v4.u32"),),
    "full grid": ((GRID, "groups"),),
}


def build(tmp: str) -> dict:
    """name -> (the loaded library, max registers, spilled bytes)."""
    src = (_build.CSRC / "embedding_bag.cu").read_text()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in the source")
            text = text.replace(old, new)
        path = os.path.join(tmp, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        out = path[:-3] + ".so"
        procs[name] = (out, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
             path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (out, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(out)
        lib.repro_embedding_bag.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        libs[name] = (lib, max(map(int, re.findall(
            r"Used (\d+) registers", log))), sum(map(int, re.findall(
                r"(\d+) bytes spill stores", log))))
    return libs


def call(lib, table, ids, vector: int):
    B, bag = ids.shape
    out = torch.empty((B, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    err = lib.repro_embedding_bag(
        _build.ptr(table), _build.ptr(ids), _build.ptr(out), B, bag,
        table.shape[0], table.shape[1], 1,
        int(table.dtype == torch.bfloat16), vector, _build.stream_of(table))
    _build.check(err, "embedding_bag variant")
    return out


def main() -> None:
    dev = torch.device("cuda")
    print(S.card_name(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        for name, (_, regs, spill) in libs.items():
            print(f"[variant] {name}: at most {regs} registers a thread, "
                  f"{spill} bytes spilled in all", flush=True)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        table = torch.randn((S.BAG_ROWS, S.BAG_DIM), generator=gen,
                            device=dev)
        uniform = {B: torch.randint(0, S.BAG_ROWS, (B, S.BAG_SIZE),
                                    generator=gen, device=dev,
                                    dtype=torch.int32)
                   for B in S.BAG_BATCHES}
        skewed = torch.as_tensor(next(CTRStream(get_arch("wide-deep"),
                                                262_144))["bags"][:, 0]
                                 .copy(), device=dev)
        cases = {"fp32 uniform B=512": (table, uniform[512]),
                 "fp32 uniform B=65536": (table, uniform[65536]),
                 "bf16 uniform B=65536": (table.bfloat16(), uniform[65536]),
                 "fp32 skewed B=262144": (table, skewed),
                 "bf16 skewed B=262144": (table.bfloat16(), skewed)}
        order = list(libs)
        base = libs["as built"][0]
        for case, (t, ids) in cases.items():
            want = EB.embedding_bag_plain(t, ids)
            times: dict = {"lane": []}
            for names in (order, order[::-1]):
                times["lane"].append(S.cuda_ms(
                    lambda: call(base, t, ids, 0), 20, repeats=3,
                    ahead=True))
                for name in names:
                    lib = libs[name][0]
                    if not torch.equal(call(lib, t, ids, 1), want):
                        raise AssertionError(f"{name} {case}: differs from "
                                             "the plain version")
                    times.setdefault(name, []).append(S.cuda_ms(
                        lambda: call(lib, t, ids, 1), 20, repeats=3,
                        ahead=True))
            print(f"[variant] {case}: device ms " + "; ".join(
                f"{k} " + " / ".join(f"{v:.4f}" for v in vs)
                for k, vs in times.items()), flush=True)


if __name__ == "__main__":
    main()
