"""Distance block over pre-gathered rows, and the dense distance matrix:
CUDA kernel wrappers + their plain versions.

:func:`block_distances` replaces the reference's
``kernels/l2dist.py::block_distances_pallas`` (fp32 and int8 bodies).  Its
caller on the search path is ``hotpath.scan_distances``, the brute-force
scan of the delta shard.  :func:`distance_matrix` replaces
``kernels/l2dist.py::distance_matrix_pallas``.  Both launch one
tensor-core tile, ``csrc/block.cu``'s ``dm_kernel``, whose header note
gives the bounds and the design.

``out[s, q, c] = qn + vn - 2 <Q[s, q], V[s, c]>`` (``-<., .>`` for ip/cos),
3.4e38 where ``mask`` is False.  With ``v_scales`` the rows of V are int8
codes, dequantized as ``code * scale`` before the same formula.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

INF = 3.4e38
# the compiled tile bodies, in repro_block_attrs' order: float32 (the
# block's and the matrix's), bf16 (the matrix's), int8 codes (the block's)
DM_BODIES = ["dm_f32", "dm_f32_scalar", "dm_bf16", "dm_bf16_scalar",
             "dm_i8", "dm_i8_scalar"]
MAX_TILES = 2 ** 31 - 1   # tiles of one row s: the grid's x dimension


def block_distances_plain(Q, V, mask=None, v_scales=None, *,
                          metric: str = "l2") -> torch.Tensor:
    """The same function in plain PyTorch (any device): Q [S, Kq, d] x
    V [S, C, d] (int8 codes when ``v_scales`` [S, C] is given) x
    mask [S, C] -> [S, Kq, C] float32."""
    if v_scales is not None:
        V = V.to(torch.float32) * v_scales[:, :, None]
    dots = torch.bmm(Q, V.transpose(1, 2))
    if metric in ("ip", "cos"):
        dist = -dots
    else:
        qn = torch.sum(Q * Q, dim=2)
        vn = torch.sum(V * V, dim=2)
        dist = qn[:, :, None] + vn[:, None, :] - 2.0 * dots
    if mask is None:
        return dist
    return torch.where(mask[:, None, :], dist, torch.full_like(dist, INF))


# the element types of the kernel API's float operands (the bag's table,
# the SpMM's features and W)
FLOAT_DTYPES = (torch.float32, torch.bfloat16)


def check_dtypes(**tensors) -> None:
    """Raise ``ValueError`` unless each named tensor is float32 or
    bfloat16 (on any device: the CPU must not accept what the card
    refuses)."""
    for name, t in tensors.items():
        if t.dtype not in FLOAT_DTYPES:
            raise ValueError(f"{name}: float32 or bfloat16, got {t.dtype}")


def check(t, name, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (a None entry of ``shape`` matches any size)."""
    if t.dtype != dtype or t.dim() != len(shape) or t.device != device \
            or not t.is_contiguous() or any(
                want is not None and got != want
                for got, want in zip(t.shape, shape)):
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape "
            f"{tuple('*' if s is None else s for s in shape)} on {device}, "
            f"got {tuple(t.shape)} {t.dtype} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


@functools.cache
def _tile() -> tuple:
    """The tile's shape (query rows, rows of V), as ``block.cu`` defines
    it."""
    fn = _build.library("block").repro_block_tile
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = None
    rows, cols = ctypes.c_int(), ctypes.c_int()
    fn(ctypes.byref(rows), ctypes.byref(cols))
    return rows.value, cols.value


def check_tiles(rows: int, cols: int) -> None:
    """Raise unless a [rows, cols] output fits the tile grid: at most
    :data:`MAX_TILES` of ``block.cu``'s tiles."""
    tr, tc = _tile()
    tiles = -(-rows // tr) * -(-cols // tc)
    if tiles > MAX_TILES:
        raise ValueError(f"a [{rows}, {cols}] output needs {tiles} tiles of "
                         f"{tr} x {tc}, over the grid's {MAX_TILES}")


@functools.cache
def _block_fn():
    """The built kernel's C entry point, typed once."""
    fn = _build.library("block").repro_block_distances
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def block_distances(Q, V, mask=None, v_scales=None, *,
                    metric: str = "l2") -> torch.Tensor:
    """Q [S, Kq, d] float32 x V [S, C, d] float32 (int8 with
    ``v_scales`` [S, C] float32) x mask [S, C] bool or None ->
    [S, Kq, C] float32.  CPU tensors take :func:`block_distances_plain`;
    CUDA tensors launch ``csrc/block.cu``'s tensor-core tile (3xTF32;
    counted on ``block_distances`` or, with ``v_scales``, on
    ``block_distances_int8``), in at most 2^31 - 1 tiles a row s (a
    larger call raises)."""
    if V.device.type == "cpu":
        return block_distances_plain(Q, V, mask, v_scales, metric=metric)
    if metric not in ("l2", "ip", "cos"):
        raise ValueError(f"metric={metric!r}")
    dev = V.device
    quant = v_scales is not None
    check(V, "V", torch.int8 if quant else torch.float32, (None,) * 3, dev)
    S, C, d = V.shape
    check(Q, "Q", torch.float32, (S, None, d), dev)
    Kq = Q.shape[1]
    if mask is not None:
        check(mask, "mask", torch.bool, (S, C), dev)
    if quant:
        check(v_scales, "v_scales", torch.float32, (S, C), dev)
    check_tiles(Kq, C)
    out = torch.empty((S, Kq, C), dtype=torch.float32, device=dev)
    err = _block_fn()(_build.ptr(Q), _build.ptr(V), _build.ptr(v_scales),
                      _build.ptr(mask), _build.ptr(out), S, Kq, C, d,
                      int(metric in ("ip", "cos")), _build.stream_of(V))
    _build.check(err, "block_distances")
    _build.count("block_distances_int8" if quant else "block_distances")
    return out


def distance_matrix_plain(Q, X, *, metric: str = "l2") -> torch.Tensor:
    """The same function in plain PyTorch (any device): Q [B, d] x
    X [N, d], upcast to float32 -> [B, N] float32 (``-dots`` for ip and
    cos: the caller normalises for cos, as the reference does)."""
    return block_distances_plain(Q.to(torch.float32)[None],
                                 X.to(torch.float32)[None],
                                 metric=metric)[0]


@functools.cache
def _matrix_fn():
    """The built kernel's C entry point, typed once."""
    fn = _build.library("block").repro_distance_matrix
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def distance_matrix(Q, X, *, metric: str = "l2") -> torch.Tensor:
    """Q [B, d] x X [N, d], both float32 or both bfloat16 -> [B, N]
    float32.  CPU tensors take :func:`distance_matrix_plain`; CUDA tensors
    launch ``csrc/block.cu``'s tensor-core tile (3xTF32 for float32, one
    bf16 product for bfloat16; counted on ``distance_matrix``), in at
    most 2^31 - 1 tiles (a larger call raises).
    Replaces the reference's ``kernels/l2dist.py::distance_matrix_pallas``."""
    if X.device.type == "cpu":
        return distance_matrix_plain(Q, X, metric=metric)
    if metric not in ("l2", "ip", "cos"):
        raise ValueError(f"metric={metric!r}")
    if X.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"X: float32 or bfloat16 rows, got {X.dtype}")
    dev = X.device
    check(X, "X", X.dtype, (None, None), dev)
    N, d = X.shape
    check(Q, "Q", X.dtype, (None, d), dev)
    B = Q.shape[0]
    check_tiles(B, N)
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    err = _matrix_fn()(_build.ptr(Q), _build.ptr(X), _build.ptr(out), B, N, d,
             int(metric in ("ip", "cos")), int(X.dtype == torch.bfloat16),
             _build.stream_of(X))
    _build.check(err, "distance_matrix")
    _build.count("distance_matrix")
    return out


def body_attributes() -> dict:
    """Registers and spilled (local) bytes a thread of each compiled tile
    body, as the card reports them: ``{"dm_f32": (regs, local), ...}``
    ("_scalar": the element-wise staging for rows that are not 16-byte
    pieces or not 16-byte aligned)."""
    return _build.body_attributes("block", "repro_block_attrs", DM_BODIES)
