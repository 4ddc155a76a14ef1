"""Host-side streaming mutation state: tombstones + delta shard (the
reference's ``ann/delta.py``, in numpy).

A built index is frozen device state; streaming writes accumulate in a
small host-side :class:`StreamState` owned by the serving engine:

* ``base_alive`` — a bool mask over the base corpus.  ``delete`` of a base
  id flips its bit; the mask threads into the searches' keep-masks
  (``alive=``), so a tombstoned node is still routed through but never
  ranked, seeded from or returned;
* :class:`DeltaShard` — an append-only, capacity-padded buffer of added
  vectors, scanned brute-force by every query
  (``hotpath.scan_distances``) and fused with the graph's results by
  ``distributed.merge_topk``.  Delta rows answer at global ids
  ``n_base + slot``, stable until compaction renumbers the corpus.

The capacity doubles from ``cfg.delta_min_cap``.  Dead slots ride along as
masked lanes until :func:`repro_torch.ann.compaction.compact` folds
everything into a fresh generation.  The methods are not thread-safe on
their own: the engine serialises every mutation under its lock.
"""
from __future__ import annotations

import numpy as np

# floor on the first allocated capacity (cfg.delta_min_cap overrides it)
MIN_CAP = 256


class DeltaShard:
    """Append-only capacity-padded vector buffer: ``X [cap, d] float32``
    and ``alive [cap] bool``.  Slots ``[count:]`` are unfilled
    (alive=False); slots below ``count`` may be tombstoned."""

    def __init__(self, d: int, *, min_cap: int = MIN_CAP):
        self.d = int(d)
        self.cap = max(1, int(min_cap))
        self.count = 0
        self.X = np.zeros((self.cap, self.d), np.float32)
        self.alive = np.zeros((self.cap,), bool)

    def append(self, V: np.ndarray) -> np.ndarray:
        """Copy rows of ``V [m, d]`` into the next free slots, doubling the
        capacity as needed; returns the slot indices [m] int64."""
        m = V.shape[0]
        need = self.count + m
        if need > self.cap:
            new_cap = self.cap
            while new_cap < need:
                new_cap *= 2
            X = np.zeros((new_cap, self.d), np.float32)
            alive = np.zeros((new_cap,), bool)
            X[:self.count] = self.X[:self.count]
            alive[:self.count] = self.alive[:self.count]
            self.X, self.alive, self.cap = X, alive, new_cap
        slots = np.arange(self.count, need, dtype=np.int64)
        self.X[self.count:need] = V
        self.alive[self.count:need] = True
        self.count = need
        return slots

    def n_alive(self) -> int:
        return int(self.alive[:self.count].sum())


class StreamState:
    """The whole mutation log of one index generation (see module doc)."""

    def __init__(self, n_base: int, d: int, *, min_cap: int = MIN_CAP):
        self.n_base = int(n_base)
        self.base_alive = np.ones((self.n_base,), bool)
        self.delta = DeltaShard(d, min_cap=min_cap)

    @property
    def dirty(self) -> bool:
        """Any mutation recorded since this generation was built?"""
        return self.delta.count > 0 or not self.base_alive.all()

    def n_active(self) -> int:
        """Rows a search can return: live base rows + live delta rows."""
        return int(self.base_alive.sum()) + self.delta.n_alive()

    def n_total(self) -> int:
        """The id space: base rows + assigned delta slots (dead included)."""
        return self.n_base + self.delta.count

    def add(self, V: np.ndarray) -> np.ndarray:
        """Append [m, d] float32 rows; returns their global ids [m]."""
        return self.n_base + self.delta.append(V)

    def delete(self, ids) -> int:
        """Tombstone global ids.  All-or-nothing: every id is validated
        (an integer, in range, not already tombstoned, not repeated in the
        request) before any bit flips, so a rejected request leaves the
        index untouched.  Returns the number of ids tombstoned."""
        arr = np.asarray(ids)
        if arr.ndim == 0:
            arr = arr[None]
        if arr.size == 0:
            return 0
        if arr.dtype.kind not in "iu":
            raise KeyError(
                f"ids must be integers, got dtype {arr.dtype!r}")
        arr = arr.astype(np.int64).ravel()
        n_total = self.n_total()
        seen: set = set()
        for i in arr.tolist():
            if i < 0 or i >= n_total:
                raise KeyError(
                    f"id {i} out of range [0, {n_total}) "
                    f"({self.n_base} base rows + {self.delta.count} delta "
                    "rows)")
            if i in seen:
                raise KeyError(f"duplicate id {i} in delete request")
            seen.add(i)
            alive = (self.base_alive[i] if i < self.n_base
                     else self.delta.alive[i - self.n_base])
            if not alive:
                raise KeyError(f"id {i} already deleted")
        for i in arr.tolist():
            if i < self.n_base:
                self.base_alive[i] = False
            else:
                self.delta.alive[i - self.n_base] = False
        return int(arr.size)

    def device_view(self) -> tuple:
        """(base_alive [n_base] bool, delta_X [cap, d] f32, delta_alive
        [cap] bool) — copies, so the plane's device snapshot is immune to
        later host-side mutation."""
        return (self.base_alive.copy(), self.delta.X.copy(),
                self.delta.alive.copy())

    @classmethod
    def restore(cls, base_alive, delta_X, delta_alive, *,
                min_cap: int = MIN_CAP) -> "StreamState":
        """Rebuild from persisted arrays (artifact format v3 and later):
        the delta arrays hold only the assigned slots, whose count is
        their length; the capacity re-pads here."""
        base_alive = np.asarray(base_alive, bool)
        delta_X = np.asarray(delta_X, np.float32)
        delta_alive = np.asarray(delta_alive, bool)
        st = cls(base_alive.shape[0], delta_X.shape[1], min_cap=min_cap)
        st.base_alive[:] = base_alive
        count = delta_X.shape[0]
        if count:
            st.delta.append(delta_X)
            st.delta.alive[:count] = delta_alive
        return st
