"""The two training backward kernels' outputs at their main paths' shapes,
saved from one tree and compared bit for bit with another's: the share of
elements whose 32 bits are equal.

    PYTHONPATH=<tree>/src python tools/bwd_bits.py --save DIR
    python tools/bwd_bits.py --compare DIR_A DIR_B

The inputs are ``tools/bwd_trace.py``'s, made from seeds on the card:
``embedding_bag_bwd`` on Wide & Deep's first bag field at ``train_batch``
(``CTRStream(seed=0)``'s ids, B = 65,536 x 10, V = 10^7, E = 32), mean and
sum; ``packed_spmm_bwd`` at minibatch_lg's layer (``fanout_neighbors(1024,
(15, 10))``, N = Nf = 169,984, d = f = 128), mean and sum.  A dtable
keeps the rows the ids read, and whether every other row is +0.0 bit for
bit; dfeat and dW are kept whole.  Run each tree in its own process (an
older one unpacked under the gitignored ``parent/``), on one card.
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as CS  # noqa: E402


def save(out: str) -> None:
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.recsys import CTRStream
    from repro_torch.data.sampler import fanout_neighbors
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.kernels import segment_matmul as SM

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(30)
    cfg = get_arch("wide-deep")
    V, E = cfg.vocab_sizes[cfg.multi_hot_fields[0]], cfg.embed_dim
    ids = torch.from_numpy(next(CTRStream(cfg, CS.FAMILY_BAG_BATCH, seed=0))
                           ["bags"][:, 0].copy()).to(dev)
    dout = torch.randn((ids.shape[0], E), generator=gen, device=dev)
    read = torch.zeros(V, dtype=torch.bool, device=dev)
    read[ids.long().clamp(0, V - 1).flatten()] = True
    kept = {}
    for combine in ("mean", "sum"):
        dtable = EB.embedding_bag_bwd(ids, dout, V, combine=combine)
        kept[f"dtable_{combine}"] = dtable[read].cpu()
        kept[f"dtable_{combine}_rest_zero"] = bool(
            (dtable[~read].view(torch.int32) == 0).all())
        del dtable
        torch.cuda.empty_cache()
    nbrs = torch.from_numpy(fanout_neighbors(CS.GNN_BATCH_NODES,
                                             CS.GNN_FANOUTS)).to(dev)
    N = nbrs.shape[0]
    d = f = CS.GNN_HIDDEN
    h = torch.randn((N, d), generator=gen, device=dev)
    w = torch.randn((d, f), generator=gen, device=dev) / d ** 0.5
    dout = torch.randn((N, f), generator=gen, device=dev)
    for combine in ("mean", "sum"):
        dfeat, dw = SM.packed_spmm_bwd(nbrs, h, w, dout, combine=combine)
        kept[f"dfeat_{combine}"], kept[f"dw_{combine}"] = dfeat.cpu(), dw.cpu()
    os.makedirs(out, exist_ok=True)
    torch.save(kept, os.path.join(out, "bwd_bits.pt"))
    print(json.dumps({"saved": out, "card": CS.card_name()}))


def compare(a: str, b: str) -> None:
    import torch

    ka, kb = (torch.load(os.path.join(x, "bwd_bits.pt")) for x in (a, b))
    out = {}
    for k in ka:
        x, y = ka[k], kb[k]
        if isinstance(x, bool):
            out[k] = [x, y]
            continue
        same = x.view(torch.int32) == y.view(torch.int32)
        out[k] = dict(elements=same.numel(),
                      bit_equal_share=float(same.double().mean()),
                      max_abs_diff=float((x.double() - y.double()).abs()
                                         .max()))
        print(f"[bits] {k}: {out[k]['bit_equal_share']:.6%} of "
              f"{out[k]['elements']} elements bit equal, largest "
              f"difference {out[k]['max_abs_diff']:.3g}")
    print(json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--save")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.save:
        save(args.save)
    if args.compare:
        compare(*args.compare)
    return 0


if __name__ == "__main__":
    sys.exit(main())
