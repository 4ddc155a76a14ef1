"""The grouping of a gather's lanes by the row they read, shared by the
two training backward kernels (``embedding_bag_bwd``, ``packed_spmm_bwd``):
its integers on the card, and its plain version.

A lane of a gather reads one row of a table, or none; the gradient adds
each lane's term into the row it read, in lane order.  The card's
grouping (``csrc/lane_groups.cuh``) is a stable sort of the valid lanes by
their row, so the integers are those of :func:`lane_groups_plain`:

* ``lanes``: the valid lanes (flat indices into ``targets``), sorted by
  row, stably (each row's lanes in lane order);
* ``rows``: the distinct rows read, ascending; ``starts``: each one's
  first position in ``lanes``, and ``len(lanes)`` last;
* ``counts``: the valid lanes of each row of ``targets`` (a neighbour row's
  c_i); ``active``: the rows of ``targets`` with a valid lane, ascending.

The card keeps the counts it finds (valid lanes, distinct rows, active
rows) in ``meta`` on the device, so building the grouping syncs nothing;
:meth:`Groups.integers` reads them back (a sync) for the tests.
"""
from __future__ import annotations

import torch

# meta: the valid lanes, the distinct rows, the active neighbour rows
# (csrc/lane_groups.cuh kMeta*)
META_VALID, META_DISTINCT, META_ACTIVE = 0, 1, 2
META_INTS = 4
FIRST_EVERY = 8         # csrc/lane_groups.cuh kScanItems


def lane_groups_plain(targets, num_rows: int) -> dict:
    """The grouping in plain PyTorch (any device): ``targets`` [N, M]
    integers, the row in [0, num_rows) each lane reads or -1 for none ->
    ``{"lanes", "rows", "starts", "counts", "active"}`` as int64 (see the
    module note)."""
    t = targets.long()
    if t.dim() != 2:
        raise ValueError(f"targets: [N, M], got {tuple(t.shape)}")
    if bool((t >= num_rows).any()):
        raise ValueError(f"a target is not below num_rows={num_rows}")
    flat = t.reshape(-1)
    valid = torch.nonzero(flat >= 0).reshape(-1)
    keys = flat[valid]
    order = torch.sort(keys, stable=True).indices
    rows, per = torch.unique_consecutive(keys[order], return_counts=True)
    counts = (t >= 0).sum(1)
    return {"lanes": valid[order], "rows": rows,
            "starts": torch.cat([per.new_zeros(1), per.cumsum(0)]),
            "counts": counts,
            "active": torch.nonzero(counts > 0).reshape(-1)}


class Groups:
    """The card's grouping of at most ``L`` lanes (and, with ``N`` not
    None, the per-row integers of N rows of a neighbour matrix): int32
    tensors at their bounds (``lanes``, ``rows`` [L], ``starts`` [L + 1],
    ``counts``, ``active``, ``rank`` [N]: each row's place in ``active``
    or -1) and ``meta`` [META_INTS], the counts found on the card."""

    def __init__(self, L: int, N: int | None, device):
        i32 = dict(dtype=torch.int32, device=device)
        self.N = N
        rows = max(N or 0, 1)
        self.lanes = torch.empty(max(L, 1), **i32)
        self.rows = torch.empty(max(L, 1), **i32)
        self.starts = torch.empty(L + 1, **i32)
        # the row of every FIRST_EVERY-th sorted position (the sum's blocks)
        self.firsts = torch.empty(max(-(-L // FIRST_EVERY), 1), **i32)
        self.meta = torch.empty(META_INTS, **i32)
        self.counts = torch.empty(rows, **i32)
        self.active = torch.empty(rows, **i32)
        self.rank = torch.empty(rows, **i32)

    def integers(self) -> dict:
        """The integers of :func:`lane_groups_plain`, cut to the counts in
        ``meta`` (read back: a sync), as int64 on the card; the per-row
        ones only for a neighbour matrix's grouping."""
        meta = self.meta.tolist()
        valid, distinct, active = (meta[k] for k in (
            META_VALID, META_DISTINCT, META_ACTIVE))
        out = {"lanes": self.lanes[:valid], "rows": self.rows[:distinct],
               "starts": self.starts[:distinct + 1]}
        if self.N is not None:
            out.update(counts=self.counts[:self.N],
                       active=self.active[:active])
        return {k: v.long() for k, v in out.items()}
