"""ANN serving launcher — build (or load) a TSDG index and serve batches
(the reference's ``repro.launch.serve``, on the port).

  PYTHONPATH=src python -m repro_torch.launch.serve [--n 20000 --d 32] \
      [--data vectors.npy --queries queries.npy] [--batches 20] [--k 10] \
      [--save-index DIR | --load-index DIR] [--mesh D|DxM] \
      [--router replicated:N|sharded:N [--replica-endpoints a,b,...] \
       [--health-interval S] [--kill-replica IDX]] [--device cpu]

Drives the :class:`repro_torch.ann.Index` facade on the card (``--device
cpu`` runs the plain PyTorch path on the CPU instead): staged build (or
artifact load), automatic regime dispatch and the engine's cache of one
CUDA graph per (regime, bucket, k).  ``--save-index`` after a run writes
the versioned artifact, ``--load-index`` on the next run skips the
rebuild.  A CUDA graph binds device addresses and has no serialized form,
so an artifact carries no executables: a loaded index captures its graphs
again (at ``--warmup`` or on first use), and ``aot_primed`` in the stats
line stays 0.

With --data/--queries, serves real vectors; otherwise a synthetic clustered
corpus with exact ground truth (recall is then reported per batch).

``--mesh D`` or ``DxM`` serves through the mesh plane: a logical grid of D
DB shards (times M query columns) on the one device
(:mod:`repro_torch.core.distributed`).

``--router`` puts the request router in front: N replicated endpoints
sharing the index's plane and graphs (QPS scale-out), or N sharded
sub-indexes fanned out and merged (capacity scale-out), with
health-checked eject/readmit and a final aggregated stats line
(``[router] compiles=... lost_futures=...``).  ``--kill-replica IDX`` is
the chaos drill: the endpoint dies mid-stream and replicated mode must
finish with ``lost_futures=0``.

``--backend`` takes the port's values (``auto``: the hand-written kernels
on the card, the plain path on the CPU; ``cuda``; ``torch``: the plain
path anywhere); ``--gather-fused`` is accepted and changes nothing (the
port's distance kernel always gathers in-kernel).
"""
import argparse
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", help="npy [N, d] float32 corpus")
    ap.add_argument("--queries", help="npy [B, d] float32 queries")
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--k", type=int, default=None,
                    help="neighbors per query (default: 10, or the saved "
                         "index's k with --load-index)")
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--metric", default="l2", choices=("l2", "ip", "cos"))
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "cuda", "torch"),
                    help="hot-path kernel backend (auto = the CUDA kernels "
                         "on the card, the plain PyTorch path on the CPU; "
                         "torch = the plain path anywhere)")
    ap.add_argument("--gather-fused", default="auto",
                    choices=("auto", "on", "off"),
                    help="accepted for the reference's command line; the "
                         "port's distance kernel always gathers in-kernel")
    ap.add_argument("--quantization", default="none",
                    choices=("none", "int8"),
                    help="int8 = compressed residency: score per-row "
                         "symmetric int8 codes in-kernel, then re-rank the "
                         "top rerank_mult*k survivors against the exact "
                         "fp32 rows")
    ap.add_argument("--mesh", metavar="DxM",
                    help="serve through the mesh execution plane: 'D' or "
                         "'DxM' shard counts for the data (DB shards) and "
                         "model (query fan-out) axes, e.g. --mesh 4x2, a "
                         "logical grid on the one device. Combines with "
                         "--save-index/--load-index: sharded artifacts "
                         "restore onto a grid of the same shard count "
                         "without a rebuild")
    ap.add_argument("--router", metavar="MODE:N",
                    help="serve through the request router: "
                         "'replicated:N' dispatches each batch to one of N "
                         "replicas of the index (shared plane and graphs, "
                         "least-loaded policy); 'sharded:N' splits the "
                         "corpus into N contiguous sub-indexes and fans "
                         "every batch out, merging per-shard top-k into "
                         "global ids")
    ap.add_argument("--replica-endpoints", metavar="NAME,NAME,...",
                    help="comma-separated endpoint names for --router "
                         "(default r0..rN-1 / s0..sN-1); count must match N")
    ap.add_argument("--health-interval", type=float, default=1.0,
                    metavar="SECONDS",
                    help="router health-probe period; a replica whose probe "
                         "fails is ejected within one interval and "
                         "readmitted after recovering (0 disables probing)")
    ap.add_argument("--kill-replica", type=int, default=None, metavar="IDX",
                    help="chaos drill: kill endpoint IDX halfway through "
                         "the batch stream (replicated mode retries on a "
                         "healthy peer — zero lost futures)")
    ap.add_argument("--calibrate", action="store_true",
                    help="fit the regime-dispatch threshold from timed "
                         "probe batches at init (paper §4's per-device "
                         "fit) instead of the static config value; the "
                         "fit is kept in a saved artifact")
    ap.add_argument("--save-index", metavar="DIR",
                    help="write the versioned index artifact (graph + "
                         "config) after serving")
    ap.add_argument("--load-index", metavar="DIR",
                    help="load a saved artifact instead of building "
                         "(skips the rebuild; the graphs are captured "
                         "again)")
    ap.add_argument("--warmup", action="store_true",
                    help="capture every reachable (regime, bucket) graph "
                         "before serving")
    ap.add_argument("--paper-faithful", action="store_true",
                    help="disable every beyond-paper feature")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "runs the plain PyTorch path)")
    args = ap.parse_args()

    import dataclasses

    from repro_torch.ann import Index
    from repro_torch.configs.base import ANNConfig
    from repro_torch.data.synthetic import make_clustered, recall_at_k
    from repro_torch.device import resolve_device

    # validate router flags before any expensive build (did-you-mean
    # messages come from parse_router_spec)
    router_cfg = None
    if args.router:
        from repro_torch.serve.router import parse_router_spec

        names = ()
        if args.replica_endpoints:
            names = tuple(x.strip()
                          for x in args.replica_endpoints.split(",")
                          if x.strip())
        try:
            router_cfg = parse_router_spec(
                args.router, health_interval_s=args.health_interval,
                endpoint_names=names)
        except ValueError as e:
            raise SystemExit(f"--router: {e}")
        if (args.kill_replica is not None
                and not 0 <= args.kill_replica < router_cfg.replicas):
            raise SystemExit(
                f"--kill-replica {args.kill_replica} out of range for "
                f"{router_cfg.replicas} replicas")
    elif args.replica_endpoints or args.kill_replica is not None:
        raise SystemExit(
            "--replica-endpoints/--kill-replica only apply with --router")

    mesh = None
    if args.mesh:
        from repro_torch.core.distributed import make_mesh

        try:
            dims = tuple(int(x) for x in args.mesh.lower().split("x"))
        except ValueError:
            raise SystemExit(f"--mesh {args.mesh!r} must be 'D' or 'DxM' "
                             "integers, e.g. --mesh 4x2")
        axes = ("data",) if len(dims) == 1 else ("data", "model")
        if len(dims) > 2:
            raise SystemExit("--mesh takes at most two axes (data[xmodel])")
        mesh = make_mesh(dims, axes, device=args.device)
        print(f"[serve] mesh plane: {dict(zip(axes, dims))} "
              f"({int(np.prod(dims))} cells on {mesh.device})")
    dev = resolve_device(args.device) if mesh is None else mesh.device

    gt = None
    if args.data:
        X = np.load(args.data).astype(np.float32)
        Q = np.load(args.queries).astype(np.float32)
    else:
        ds = make_clustered(n=args.n, d=args.d, n_queries=512,
                            n_clusters=64, noise=0.6, metric=args.metric,
                            device=dev)
        X, Q, gt = ds.X, ds.Q, ds.gt

    place = {"mesh": mesh} if mesh is not None else {"device": dev}
    t0 = time.perf_counter()
    if args.load_index:
        # build-time knobs are baked into the artifact; flag any the
        # caller tried to override instead of silently dropping them
        ignored = [f"--{n.replace('_', '-')}" for n, default in
                   (("metric", "l2"), ("backend", "auto"),
                    ("gather_fused", "auto"), ("quantization", "none"),
                    ("paper_faithful", False), ("calibrate", False))
                   if getattr(args, n) != default]
        if ignored:
            print(f"[serve] note: {' '.join(ignored)} ignored with "
                  "--load-index (the artifact's saved config governs)")
        index = Index.load(args.load_index, **place)
        print(f"[serve] index loaded from {args.load_index} in "
              f"{time.perf_counter() - t0:.1f}s "
              f"(plane={index.plane.name}, "
              f"aot_primed={index.stats.aot_primed}, no rebuild; its "
              "graphs are captured again, at --warmup or on first use)")
    else:
        cfg = dataclasses.replace(ANNConfig(),
                                  metric=args.metric,
                                  kernel_backend=args.backend,
                                  gather_fused=args.gather_fused,
                                  quantization=args.quantization,
                                  regime_calibration=("probe" if
                                                      args.calibrate
                                                      else "static"))
        if args.paper_faithful:
            cfg = dataclasses.replace(cfg, bridge_hubs=0, large_n_seeds=32,
                                      db_bf16=False, gather_limit=0)
        index = Index.build(X, cfg, k=args.k if args.k is not None else 10,
                            **place)
        line = (f"[serve] index: N={X.shape[0]} d={X.shape[1]} "
                f"avg_degree={index.graph.avg_degree():.1f} "
                f"built in {time.perf_counter() - t0:.1f}s "
                f"(kernel backend: {index.backend}, "
                f"plane: {index.plane.name}, device: {index.device}"
                + (f", quantization: {args.quantization}"
                   if args.quantization != "none" else "") + ")")
        if index.calibration is not None:
            cal = index.calibration
            line += (f"\n[serve] calibrated regime threshold: "
                     f"{index.engine.threshold:.1f} "
                     f"(crossover B*={cal.crossover_batch:.1f}, "
                     f"degenerate={cal.degenerate})")
        print(line)
    # a --k differing from the saved index's k still works (the engine
    # makes that (regime, bucket, k) entry on demand)
    k = args.k if args.k is not None else index.k
    if args.warmup:
        t0 = time.perf_counter()
        n = index.warmup(k=k)
        print(f"[serve] warmup: {n} compiles (cache entries; CUDA graphs "
              f"on the card) in {time.perf_counter() - t0:.1f}s")

    router = None
    if router_cfg is not None:
        router = index.serve(router=router_cfg)
        print(f"[router] mode={router_cfg.mode} "
              f"endpoints={[e.name for e in router.endpoints]} "
              f"policy={router_cfg.policy} "
              f"health_interval={router_cfg.health_interval_s}s")

    rng = np.random.default_rng(0)
    hits = total = 0
    try:
        for i in range(args.batches):
            if (router is not None and args.kill_replica is not None
                    and i == args.batches // 2):
                victim = router.endpoints[args.kill_replica]
                victim.kill()
                print(f"[router] killed replica {victim.name!r} at batch "
                      f"{i} (chaos drill — in-flight and later requests "
                      "fail over)")
            B = int(rng.choice([1, 4, 16, 64, 256]))
            sel = rng.integers(0, len(Q), B)
            t1 = time.perf_counter()
            if router is not None:
                ids, dists = router.query(Q[sel], k=k)
            else:
                ids, dists = index.search(Q[sel], k=k)
            dt = (time.perf_counter() - t1) * 1e3
            line = (f"[serve] batch {i:3d} B={B:4d} "
                    f"regime={index.regime(B):5s} {dt:7.1f} ms")
            if gt is not None:
                r = recall_at_k(ids, gt[sel], k)
                hits += r * B
                total += B
                line += f"  recall@{k}={r:.3f}"
            print(line, flush=True)
    finally:
        if router is not None:
            snap = router.snapshot()
            router.close()
    if router is not None:
        agg, rt = snap["aggregate"], snap["router"]
        print(f"[router] {rt['n_requests']} requests / "
              f"{rt['n_dispatches']} dispatches over "
              f"{agg['n_replicas']} endpoints "
              f"({agg['healthy_replicas']} healthy), "
              f"{agg['n_queries']} queries "
              f"({agg['small_batches']} small, {agg['large_batches']} "
              f"large batches), {agg['qps']:.0f} QPS aggregate"
              + (f", weighted recall {hits / total:.3f}" if total else ""))
        print(f"[router] compiles={agg['compiles']} "
              f"aot_primed={agg['aot_primed']} "
              f"lost_futures={rt['lost_futures']} "
              f"retries={rt['retries']} ejects={rt['ejects']} "
              f"readmits={rt['readmits']} probes={rt['probes']} "
              f"expired={agg['expired']}")
    else:
        s = index.stats
        print(f"[serve] {s.n_queries} queries / {s.n_batches} batches "
              f"({s.small_batches} small, {s.large_batches} large), "
              f"{s.qps:.0f} QPS steady-state"
              + (f", weighted recall {hits / total:.3f}" if total else ""))
        print(f"[serve] compiles={s.compiles} aot_primed={s.aot_primed} "
              f"bucket_hit_rate={s.bucket_hit_rate:.2f} "
              f"padded_queries={s.padded_queries}")
    if args.save_index:
        t0 = time.perf_counter()
        index.save(args.save_index)
        print(f"[serve] artifact written to {args.save_index} in "
              f"{time.perf_counter() - t0:.1f}s — next run: "
              f"--load-index {args.save_index}")


if __name__ == "__main__":
    main()
