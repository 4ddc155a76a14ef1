"""MACE — higher-order E(3)-equivariant message passing [arXiv:2206.07697]:
the port's copy of the reference's ``models/mace.py`` (its forward;
``loss_fn`` and its forces through ``jax.grad`` are training and are not
ported yet).

  per layer t:
    A_i^{(l3)}  = Σ_{l1,l2} CG(l1,l2→l3) · Σ_{j∈N(i)} R^t_{l1l2l3}(r_ij)
                  Y^{(l1)}(r̂_ij) ⊗ W h_j^{(l2)}          (density A-basis)
    B_i         = symmetric self-contractions of A up to order ν
    h_i^{t+1}   = W_self h_i^t + W_msg B_i                (update)
  readout: invariant (l=0) channels -> per-site energy -> Σ = total energy.

The reference's summation structure is kept: one gather of the source
features a layer, every coupling path accumulated into one per-edge
buffer, one segment sum (``index_add_``).  Each path's message is
contracted in two products, Y with the coupling tensor first.  The
reference's ``jax.checkpoint`` (rematerialisation for the backward
pass) has no counterpart in a forward-only port.  No Pallas kernel is on
this path.  Arithmetic runs in the positions' dtype (float32 as the
reference's; float64 inputs and parameters give a float64 reference);
on the card the float32 products need TF32 off, which the port does not
change.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.models.gnn import segment_sum
from repro_torch.models.module import ParamSpec, TreeModule, as_tree
from repro_torch.utils import so3


def n_irrep_dims(l_max: int) -> int:
    return (l_max + 1) ** 2


def allowed_paths(l_max: int):
    """(l1, l2, l3) with non-vanishing real CG, all <= l_max."""
    paths = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l_max, l1 + l2) + 1):
                paths.append((l1, l2, l3))
    return paths


def schema(cfg: GNNConfig) -> dict:
    C, Ln = cfg.d_hidden, cfg.n_layers
    n_paths = len(allowed_paths(cfg.l_max))
    sch: dict = {
        "species_embed": ParamSpec((cfg.n_species, C), (None, None),
                                   init="normal", scale=1.0),
        "radial": {  # MLP: n_rbf -> 2C -> n_paths*C (per layer)
            "w1": ParamSpec((Ln, cfg.n_rbf, 2 * C), ("layers", None, None)),
            "b1": ParamSpec((Ln, 2 * C), ("layers", None), init="zeros"),
            "w2": ParamSpec((Ln, 2 * C, n_paths * C),
                            ("layers", None, None)),
        },
        "w_h": ParamSpec((Ln, C, C), ("layers", None, None)),      # h mix
        "w_self": ParamSpec((Ln, C, C), ("layers", None, None)),
        "w_msg": ParamSpec((Ln, C, C), ("layers", None, None)),
        # per-order contraction weights (correlation 2..nu)
        "w_corr": ParamSpec((Ln, cfg.correlation_order - 1, C),
                            ("layers", None, None), init="normal", scale=0.3),
        "readout": {
            "w1": ParamSpec((C, C), (None, None)),
            # zero-init head: predictions start at 0 (targets standardized)
            "w2": ParamSpec((C, 1), (None, None), init="zeros"),
        },
    }
    return sch


class MACE(TreeModule):
    """The model, its parameter names the reference's leaves in its
    layouts, built from ``init_params(schema(cfg), ...)`` or
    ``convert.mace_params_from_reference``."""

    def __init__(self, cfg: GNNConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, batch):
        return forward(self, self.cfg, batch)


# --------------------------------------------------------------------------
# radial basis
# --------------------------------------------------------------------------

def bessel_basis(r, n: int, r_cut: float):
    """[E] -> [E, n]; sin(n π r / rc) / r with smooth polynomial cutoff."""
    r = torch.clamp(r, min=1e-9)
    ns = torch.arange(1, n + 1, dtype=r.dtype, device=r.device)
    rb = math.sqrt(2.0 / r_cut) * torch.sin(
        ns[None, :] * math.pi * r[:, None] / r_cut) / r[:, None]
    # polynomial cutoff (p=6)
    x = torch.clamp(r / r_cut, 0.0, 1.0)
    env = 1 - 28 * x ** 6 + 48 * x ** 7 - 21 * x ** 8
    return rb * env[:, None]


def _eq_norm(z):
    """Equivariant RMS normalisation: z times a per-node invariant scalar."""
    return z * torch.rsqrt(torch.mean(torch.square(z), dim=(1, 2),
                                      keepdim=True) + 1e-6)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def forward(params, cfg: GNNConfig, batch):
    """batch: positions [N,3], species [N], edge_src/dst [E], edge_mask [E],
    graph_ids [N], node_mask [N], energies [G] (only its length is read).
    Returns energies [G]."""
    p = as_tree(params)
    pos = batch["positions"]
    dt, dev = pos.dtype, pos.device
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    emask = batch["edge_mask"].to(dt)
    nmask = batch["node_mask"]
    N, E = pos.shape[0], src.shape[0]
    C = cfg.d_hidden
    dims = n_irrep_dims(cfg.l_max)
    paths = allowed_paths(cfg.l_max)
    slices = so3.irrep_slices(cfg.l_max)
    cg = {lll: torch.as_tensor(so3.real_cg(*lll), dtype=dt, device=dev)
          for lll in paths}

    # edge geometry
    disp = pos[dst] - pos[src]                                 # [E, 3]
    r = torch.linalg.vector_norm(disp + 1e-12, dim=-1)
    unit = disp / torch.clamp(r[:, None], min=1e-9)
    Y = so3.spherical_harmonics(unit, cfg.l_max)               # [E, dims]
    rbf = bessel_basis(r, cfg.n_rbf, cfg.r_cut) * emask[:, None]

    # node features: [N, C, dims]; init = species embed in l=0
    h = torch.zeros((N, C, dims), dtype=dt, device=dev)
    h[:, :, 0] = p["species_embed"][batch["species"].long()]

    # the density is normalised by the average neighbour count
    avg_deg = emask.sum() / torch.clamp(nmask.to(dt).sum(), min=1.0)
    inv_sqrt_deg = torch.rsqrt(torch.clamp(avg_deg, min=1.0))

    site_energy = torch.zeros((N,), dtype=dt, device=dev)
    readout = p["readout"]
    for t in range(cfg.n_layers):
        rp = {k: v[t] for k, v in p["radial"].items()}
        R = (torch.nn.functional.silu(rbf @ rp["w1"] + rp["b1"])
             @ rp["w2"]).reshape(E, len(paths), C)             # [E, P, C]
        hj = torch.einsum("ncd,cx->nxd", h, p["w_h"][t])       # premix

        # ---- A-basis: one gather, every path into one per-edge buffer ----
        hsrc = hj[src]                                         # [E, C, dims]
        msg_full = torch.zeros((E, C, dims), dtype=dt, device=dev)
        for p_idx, (l1, l2, l3) in enumerate(paths):
            _, a1, b1 = slices[l1]
            _, a2, b2 = slices[l2]
            _, a3, b3 = slices[l3]
            # R(r) * CG(Y_l1, h_j^{l2}), Y contracted with the CG first
            yc = torch.einsum("ei,ijk->ejk", Y[:, a1:b1], cg[(l1, l2, l3)])
            msg = torch.einsum("ecj,ejk->eck", hsrc[:, :, a2:b2], yc)
            msg_full[:, :, a3:b3] += msg * R[:, p_idx, :, None]
        A = segment_sum(msg_full * emask[:, None, None], dst, N) \
            * inv_sqrt_deg
        A = _eq_norm(A)

        # ---- B-basis: symmetric self-contractions up to order ν ----------
        B = A
        prod = A
        for order in range(2, cfg.correlation_order + 1):
            nxt = torch.zeros_like(A)
            for (l1, l2, l3) in paths:
                _, a1, b1 = slices[l1]
                _, a2, b2 = slices[l2]
                _, a3, b3 = slices[l3]
                nxt[:, :, a3:b3] += torch.einsum(
                    "nci,ncj,ijk->nck", prod[:, :, a1:b1], A[:, :, a2:b2],
                    cg[(l1, l2, l3)])
            prod = _eq_norm(nxt)
            B = B + p["w_corr"][t][order - 2][None, :, None] * prod

        # ---- update -------------------------------------------------------
        h = torch.einsum("ncd,cx->nxd", h, p["w_self"][t]) \
            + torch.einsum("ncd,cx->nxd", B, p["w_msg"][t])

        # per-layer invariant readout (MACE reads out every layer)
        inv = h[:, :, 0]                                       # [N, C]
        e_t = torch.nn.functional.silu(inv @ readout["w1"]) @ readout["w2"]
        site_energy = site_energy + e_t[:, 0]

    site_energy = torch.where(nmask, site_energy, 0.0)
    n_graphs = batch["energies"].shape[0]
    return segment_sum(site_energy, batch["graph_ids"], n_graphs)
