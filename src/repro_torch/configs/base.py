"""Configurations and shape specs for the PyTorch port: the ANN index,
the language models, Wide & Deep, and the arch registry.

``ANNConfig`` carries every field and default of the JAX reference's
config, so one set of knobs describes an index in either package.  Two
differences:

* ``kernel_backend`` takes ``"auto" | "cuda" | "torch"``: ``"auto"``
  resolves per call to ``"cuda"`` for CUDA tensors and ``"torch"`` for CPU
  tensors, ``"cuda"`` on a CPU tensor raises, and ``"torch"`` opts into the
  plain PyTorch path on any device (the parity comparisons use it).
* ``gather_fused`` is accepted for parity and changes nothing (the CUDA
  distance kernel always gathers rows in-kernel); ``unroll_scans`` is a
  no-op (PyTorch runs every loop eagerly).

``db_bf16=True`` makes a mesh plane's searches read a bf16 copy of each
shard's database (``core/distributed.py``).  As in the reference, only
the mesh path reads it: a single-device plane ignores it and searches the
fp32 rows.

``MoEConfig``, ``TransformerConfig``, ``LM_SHAPES``, ``GNNConfig``,
``GNN_SHAPES``, ``RecsysConfig`` and ``RECSYS_SHAPES`` are the
reference's (``src/repro/configs/base.py``) field for field,
``n_params`` and ``n_active_params`` included; ``GNN_N_CLASSES`` is the
reference's class count of each graph shape
(``src/repro/launch/steps.py``).
``remat`` puts each layer of the port's training forward under
``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``;
``scan_layers`` and ``unroll`` are kept for parity and have no effect in
the port: it runs its layers eagerly, one after another.  The registry
(``list_archs``/``get_arch``/``get_reduced``) lists the reference's archs
and serves every one of them: the five language models, the four graph
models (``gin_tu``, ``gatedgcn``, ``graphsage_reddit``, ``mace``),
``wide_deep`` and ``tsdg_paper``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode | serve | retrieval | build | search
    dims: dict


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train",
                          dict(seq_len=4096, global_batch=256)),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                             dict(seq_len=32768, global_batch=32)),
    "decode_32k": ShapeSpec("decode_32k", "decode",
                            dict(seq_len=32768, global_batch=128)),
    "long_500k": ShapeSpec("long_500k", "decode",
                           dict(seq_len=524288, global_batch=1)),
}

GNN_SHAPES = {
    "full_graph_sm": ShapeSpec("full_graph_sm", "train",
                               dict(n_nodes=2708, n_edges=10556, d_feat=1433)),
    "minibatch_lg": ShapeSpec("minibatch_lg", "train",
                              dict(n_nodes=232965, n_edges=114615892,
                                   batch_nodes=1024, fanout=(15, 10),
                                   d_feat=602)),
    "ogb_products": ShapeSpec("ogb_products", "train",
                              dict(n_nodes=2449029, n_edges=61859140,
                                   d_feat=100)),
    "molecule": ShapeSpec("molecule", "train",
                          dict(n_nodes=30, n_edges=64, batch=128)),
}

# the classes of each graph shape's node or graph labels
GNN_N_CLASSES = {"full_graph_sm": 16, "minibatch_lg": 41,
                 "ogb_products": 47, "molecule": 8}

RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", dict(batch=65536)),
    "serve_p99": ShapeSpec("serve_p99", "serve", dict(batch=512)),
    "serve_bulk": ShapeSpec("serve_bulk", "serve", dict(batch=262144)),
    "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval",
                                dict(batch=1, n_candidates=1_000_000)),
}


# The paper's own system at SIFT1M scale (the reference's ANN_SHAPES).
ANN_SHAPES = {
    "build_1m": ShapeSpec("build_1m", "build", dict(n=1_048_576, d=128, k=32)),
    "search_small": ShapeSpec("search_small", "search",
                              dict(n=1_048_576, d=128, batch=10, t0=64)),
    "search_large": ShapeSpec("search_large", "search",
                              dict(n=1_048_576, d=128, batch=10240, t0=1)),
    "search_xlarge": ShapeSpec("search_xlarge", "search",
                               dict(n=16_777_216, d=96, batch=65536, t0=1)),
}

KERNEL_BACKENDS = ("auto", "cuda", "torch")


@dataclasses.dataclass(frozen=True)
class ANNConfig:
    """The paper's system (TSDG index + search)."""

    name: str = "tsdg"
    metric: str = "l2"        # l2 | ip | cos
    k_graph: int = 32         # k-NN graph degree fed to diversification
    alpha: float = 1.2        # stage-1 relaxation (Eq. 2)
    lambda0: int = 8          # stage-2 occlusion-factor threshold
    max_degree: int = 32      # packed adjacency width M
    # search defaults (paper §4)
    n_seeds: int = 32
    hop_width: int = 32       # neighbors visited per hop (warp analogue)
    small_t0: int = 64        # independent greedy searches per query
    small_hops: int = 6
    large_ef: int = 64        # R size for large-batch search
    large_hops: int = 128
    large_n_seeds: int = 128
    delta: float = 0.0
    queue_segments: int = 8   # m segments for C and V
    segment_size: int = 32
    visited_segments: int = 8
    small_batch_threshold: int = 256  # regime split (paper's a*SMs+b / d)
    regime_calibration: str = "static"
    faithful_rtemp: bool = True  # lane-paired R_temp update (paper Alg.1)
    kernel_backend: str = "auto"
    gather_fused: str = "auto"
    build_pipeline: tuple = ("knn", "diversify", "bridges")
    # beyond-paper connectivity augmentation (0 = paper-faithful off)
    bridge_hubs: int = 256
    bridge_k: int = 8
    unroll_scans: bool = False
    db_bf16: bool = False
    # gather only the first `gather_limit` λ-sorted columns of each row
    gather_limit: int = 0
    # exact per-query visited byte-table replacing the lossy circular V
    exact_visited: bool = False
    # --- serving engine ---
    serve_buckets: tuple = (8, 32, 128, 512, 2048)
    queue_max_wait_ms: float = 2.0
    queue_max_batch: int = 512
    delta_min_cap: int = 256
    quantization: str = "none"
    rerank_mult: int = 4
    visited_filter: str = "none"
    family: str = "ann"

    def __post_init__(self):
        if self.metric not in ("l2", "ip", "cos"):
            raise ValueError(
                f"metric={self.metric!r} must be one of 'l2', 'ip', 'cos'")
        if self.gather_fused not in ("auto", "on", "off"):
            raise ValueError(
                f"gather_fused={self.gather_fused!r} must be 'auto', "
                "'on', or 'off'")
        if self.regime_calibration not in ("static", "probe"):
            raise ValueError(
                f"regime_calibration={self.regime_calibration!r} must be "
                "'static' or 'probe'")
        if self.delta_min_cap < 1:
            raise ValueError(
                f"delta_min_cap={self.delta_min_cap} must be >= 1")
        if self.quantization not in ("none", "int8"):
            raise ValueError(
                f"quantization={self.quantization!r} must be 'none' or "
                "'int8'")
        if self.rerank_mult < 1:
            raise ValueError(
                f"rerank_mult={self.rerank_mult} must be >= 1")
        if self.visited_filter not in ("none", "hash"):
            raise ValueError(
                f"visited_filter={self.visited_filter!r} must be 'none' "
                "or 'hash'")
        if self.visited_filter == "hash" and self.exact_visited:
            raise ValueError(
                "visited_filter='hash' replaces the visited structures; "
                "it cannot combine with exact_visited=True")
        if self.kernel_backend not in KERNEL_BACKENDS:
            raise ValueError(
                f"kernel_backend={self.kernel_backend!r} must be one of "
                f"{KERNEL_BACKENDS}")
        if "layout" in self.build_pipeline:
            if self.gather_limit:
                raise ValueError(
                    "the 'layout' build stage re-sorts each neighbor row "
                    "by packed id, destroying the λ-ascending prefix that "
                    f"gather_limit={self.gather_limit} relies on; use "
                    "gather_limit=0 with packed layouts")
            if self.hop_width < self.max_degree:
                raise ValueError(
                    "packed layouts require hop_width >= max_degree "
                    f"(got {self.hop_width} < {self.max_degree}): the "
                    "small-batch chunked hop pairs lanes positionally, "
                    "which is only permutation-equivariant in one chunk")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2
    # group-local dispatch: tokens split into this many contiguous groups,
    # each routed to its own [E, C, d] buffers
    dispatch_groups: int = 1


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None      # None -> d_model // n_heads
    moe: MoEConfig | None = None
    window: int | None = None        # sliding-window size (starcoder2)
    local_global_ratio: int = 0      # gemma3: N local layers per global
    local_window: int = 1024
    nonparametric_ln: bool = False   # olmo
    gated_ffn: bool = True           # False -> plain 2-matrix GELU MLP
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True               # checkpoint each layer in training
    # no effect in the port (eager layers); kept for parity
    scan_layers: bool = True
    unroll: bool = False
    family: str = "lm"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def n_params(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads \
            + hd * self.n_heads * d
        if self.moe:
            ff = 3 * d * self.moe.d_expert * (self.moe.n_experts
                                              + self.moe.n_shared) \
                + d * self.moe.n_experts
        else:
            ff = (3 if self.gated_ffn else 2) * d * f
        emb = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ff) + emb

    def n_active_params(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if not self.moe:
            return self.n_params()
        d = self.d_model
        hd = self.resolved_head_dim
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads \
            + hd * self.n_heads * d
        ff = 3 * d * self.moe.d_expert * (self.moe.top_k + self.moe.n_shared) \
            + d * self.moe.n_experts
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ff) + emb


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str                 # gin | gatedgcn | mace | graphsage
    n_layers: int
    d_hidden: int
    aggregator: str = "sum"   # sum | mean | max | gated
    learnable_eps: bool = False
    sample_sizes: tuple = ()  # graphsage fanouts
    # MACE extras
    l_max: int = 2
    correlation_order: int = 3
    n_rbf: int = 8
    r_cut: float = 5.0
    n_species: int = 10
    n_classes: int = 64
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    family: str = "gnn"


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    n_sparse: int = 40
    embed_dim: int = 32
    mlp: tuple = (1024, 512, 256)
    interaction: str = "concat"
    n_dense: int = 13
    # per-field vocabulary sizes (sums to ~49M rows)
    vocab_sizes: tuple = tuple([10_000_000] * 4 + [1_000_000] * 8
                               + [100_000] * 12 + [10_000] * 16)
    multi_hot_fields: tuple = (0, 1, 2, 3)  # bag-style fields
    bag_size: int = 10
    wide_hash_buckets: int = 1_000_000
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    family: str = "recsys"


def shapes_for(cfg) -> dict:
    """The shape specs of a config's family."""
    return {"lm": LM_SHAPES, "gnn": GNN_SHAPES,
            "recsys": RECSYS_SHAPES, "ann": ANN_SHAPES}[cfg.family]


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

# the reference's archs, in its order
_ARCH_MODULES = (
    "olmoe_1b_7b", "kimi_k2_1t_a32b", "starcoder2_7b", "gemma3_27b",
    "olmo_1b", "gin_tu", "gatedgcn", "mace", "graphsage_reddit",
    "wide_deep", "tsdg_paper",
)


def list_archs() -> list:
    return [m.replace("_", "-") for m in _ARCH_MODULES]


def _arch_module(arch_id: str):
    mod_name = arch_id.replace("-", "_")
    if mod_name not in _ARCH_MODULES:
        import difflib

        close = difflib.get_close_matches(
            arch_id.replace("_", "-"), list_archs(), n=3, cutoff=0.5)
        hint = f"; did you mean {' or '.join(map(repr, close))}?" \
            if close else ""
        raise KeyError(
            f"unknown arch {arch_id!r}{hint}; known: {list_archs()}")
    import importlib

    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_arch(arch_id: str):
    return _arch_module(arch_id).CONFIG


def get_reduced(arch_id: str):
    return _arch_module(arch_id).reduced()
