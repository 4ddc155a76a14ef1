"""Time the pod (``serve/pod.py``) across the cards of one host, beside the
one-process grid over the same shards.

    PYTHONPATH=src python tools/pod_bench.py [--n 1048576] [--queries 10240]

W ranks, one a card (``cuda:r``, NCCL), hold one DB shard each of a
W-shard grid over the smoke's corpus (``make_clustered``, seed 0, d =
128).  Every rank builds its shard, the pod saves its artifact (a
collective gather, rank 0 writes), and each rank serves B = 10 and
``--queries`` with ``visited_filter`` ``"none"`` and ``"hash"``: each
replay equal to its eager call bit for bit, the median of 20 replays.
After the ranks exit, this process loads the artifact as the (W, 1) grid
on ``cuda:0`` and serves the same batches: every rank's answers must
equal the grid's bit for bit, and the grid's median of 20 replays is
printed beside the pod's.  One JSON line a search; the cards' names and
power limits first.  ``--device cpu --ranks 4`` rehearses it on the CPU
over gloo (small ``--n``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import free_port, median_ms  # noqa: E402

VISITED = ("none", "hash")


def rank_main(rank: int, tmp: str, port: int, world: int, queries: int,
              device: str) -> None:
    """One rank (a spawned process): build its shard, save the pod
    artifact, serve; answers, medians and seconds go to ``tmp``."""
    import numpy as np
    import torch

    from repro_torch.ann import Index
    from repro_torch.configs.base import ANNConfig
    from repro_torch.core import distributed as D
    from repro_torch.serve import pod

    dev = torch.device("cuda", rank) if device == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    pod.init_pod(f"tcp://localhost:{port}", world_size=world, rank=rank,
                 device=dev)
    X = np.load(os.path.join(tmp, "X.npy"))
    Q = np.load(os.path.join(tmp, "Q.npy"))
    cfg = ANNConfig()
    mesh = D.make_mesh((world,), ("data",), device=dev)
    rec: dict = {"backend": torch.distributed.get_backend(),
                 "seconds": {}, "replay_ms": {}}
    t0 = time.perf_counter()
    base = Index(None, cfg, plane=pod.PodPlane(X, cfg, mesh))
    sync()
    rec["seconds"]["build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    base.save(os.path.join(tmp, "pod_ix"))
    rec["seconds"]["save"] = time.perf_counter() - t0
    p = base.plane
    local = (p.X, p.graph.neighbors, p.graph.lambdas, p.graph.degrees,
             p._ops[4])
    answers = {}
    for visited in VISITED:
        c = dataclasses.replace(cfg, visited_filter=visited)
        index = base if visited == "none" else Index(
            None, c, plane=pod.PodPlane(None, c, mesh, parts=local,
                                        local=True))
        for B in (10, queries):
            label = f"{visited} B={B}"
            kind, bucket = index.regime(B), index.engine.bucket_for(B)
            index.search(Q[:B])                   # eager warm-up + capture
            ids, dists = index.search(Q[:B])
            Qp = torch.from_numpy(np.pad(Q[:B], ((0, bucket - B), (0, 0)),
                                         mode="edge")).to(dev)
            eager = index.plane.search(kind, Qp, 10)
            if not (np.array_equal(ids, eager[0][:B].cpu().numpy())
                    and np.array_equal(dists, eager[1][:B].cpu().numpy())):
                raise AssertionError(f"rank {rank} {label}: replay and "
                                     "eager call differ")
            rec["replay_ms"][label] = median_ms(lambda: index.search(Q[:B]))
            answers[f"{label} ids"], answers[f"{label} dists"] = ids, dists
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **answers)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    pod.close_pod()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--queries", type=int, default=10240)
    ap.add_argument("--ranks", type=int, default=None,
                    help="default: every visible card")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from repro_torch.ann import Index
    from repro_torch.configs.base import ANNConfig
    from repro_torch.core import distributed as D
    from repro_torch.data.synthetic import make_clustered, recall_at_k
    from repro_torch.kernels import _build
    from repro_torch.serve.plane import MeshPlane

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("pod_bench: no CUDA device", file=sys.stderr)
        return 2
    world = args.ranks or torch.cuda.device_count()
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    if cuda:   # every card's name and power limit, one line each
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
        _build.build_all()                    # once, before the ranks load
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    ds = make_clustered(n=args.n, d=128, n_queries=args.queries, k_gt=10,
                        seed=0, device=dev)
    np.save(os.path.join(tmp, "X.npy"), ds.X)
    np.save(os.path.join(tmp, "Q.npy"), ds.Q)
    t0 = time.perf_counter()
    ctx = mp.start_processes(
        rank_main, args=(tmp, free_port(), world, args.queries, args.device),
        nprocs=world, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > 900:
                raise AssertionError("the ranks took over 900 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            rec = json.load(f)
        with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
            rec["answers"] = {k: z[k] for k in z.files}
        ranks.append(rec)
    a0 = ranks[0]["answers"]
    if any(rec["answers"][k].tobytes() != a0[k].tobytes()
           for rec in ranks for k in a0):
        raise AssertionError("the ranks answered differently")
    mesh = D.make_mesh((world, 1), ("data", "model"), device=dev)
    grid = Index.load(os.path.join(tmp, "pod_ix"), mesh=mesh)
    gp = grid.plane
    parts = (gp.X, gp.graph.neighbors, gp.graph.lambdas, gp.graph.degrees,
             gp._ops[4])
    cfg = ANNConfig()
    print(json.dumps({"ranks": world, "backend": ranks[0]["backend"],
                      "shard_rows": args.n // world,
                      "seconds": [rec["seconds"] for rec in ranks]}))
    for visited in VISITED:
        c = dataclasses.replace(cfg, visited_filter=visited)
        index = grid if visited == "none" else Index(
            None, c, plane=MeshPlane(None, c, mesh, parts=parts))
        for B in (10, args.queries):
            label = f"{visited} B={B}"
            index.search(ds.Q[:B])                # capture
            ids, dists = index.search(ds.Q[:B])
            if not (np.array_equal(a0[f"{label} ids"], ids)
                    and np.array_equal(a0[f"{label} dists"], dists)):
                raise AssertionError(f"{label}: the pod differs from the "
                                     f"({world}, 1) grid")
            print(json.dumps({
                "search": label, "regime": index.regime(B),
                "pod_replay_ms": [rec["replay_ms"][label] for rec in ranks],
                "grid_replay_ms": median_ms(lambda: index.search(ds.Q[:B])),
                "equal_to_grid": True,
                "recall_at_10": recall_at_k(ids, ds.gt[:B], 10)}),
                flush=True)
    tmp_dir.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
