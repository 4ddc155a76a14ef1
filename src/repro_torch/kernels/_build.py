"""Build and load the port's CUDA kernels (nvcc into a plain-C shared
library, bound with ctypes).

Each ``csrc/<name>.cu`` compiles on its own, for ``sm_90a``, into
``build/repro_torch_kernels/lib<name>-<hash>.so`` under the repository
root, at first use.  The hash covers the source, the headers beside it and
the flags, so an edited source rebuilds and an unchanged one loads at once.
:func:`build_all` starts one ``nvcc`` per source together, so a cold build
takes as long as the slowest file.

Each C entry point takes raw pointers (``c_void_p``) and the CUDA stream,
launches on that stream without synchronising, and returns
``cudaGetLastError()``; :func:`check` raises when it is not 0.

Each wrapper counts its launches through :func:`count` into
:data:`LAUNCHES`, in Python.  A CUDA graph's replay runs no Python, so the
graph's owner captures inside :func:`recording` and calls
:func:`replayed` after each replay.  Recording is per thread: a capture
records only its own thread's launches, while other threads' launches
count as they happen (the router's engines capture and replay from their
own threads).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" \
    / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("l2dist", "topk", "visited", "block", "embedding_bag",
           "segment_matmul", "flash_attention", "flash_attention_bwd")
# launches of each kernel body, counted by its wrapper where it launches:
# the seven of the ANN path, then the five of the kernel API
# (kernels/ops.py), then attention's gradient (its two passes)
LAUNCHES = dict.fromkeys(("gather_distances", "gather_distances_int8",
                          "gather_distances_bf16",
                          "rank_merge", "visited_filter", "block_distances",
                          "block_distances_int8", "distance_matrix",
                          "bitonic_sort", "embedding_bag", "packed_spmm",
                          "flash_attention", "flash_attention_bwd"), 0)

_libs: dict = {}
_lock = threading.Lock()
_count_lock = threading.Lock()
_local = threading.local()   # .recording: the capture's dict, or None


def count(name: str) -> None:
    """One launch of the body ``name``: into the current thread's
    recording while it captures, else into :data:`LAUNCHES`."""
    rec = getattr(_local, "recording", None)
    if rec is not None:
        rec[name] = rec.get(name, 0) + 1
        return
    with _count_lock:
        LAUNCHES[name] += 1


@contextlib.contextmanager
def recording():
    """Launches made inside, by this thread, are recorded, not counted: a
    CUDA graph's capture records kernels without running them.  Yields a
    dict that holds the launches of each body made inside.
    :func:`replayed` counts them once per replay of the captured graph."""
    recorded: dict = {}
    outer = getattr(_local, "recording", None)
    _local.recording = recorded
    try:
        yield recorded
    finally:
        _local.recording = outer


def replayed(recorded: dict) -> None:
    """Count one replay of a graph whose capture recorded ``recorded``."""
    with _count_lock:
        for name, n in recorded.items():
            LAUNCHES[name] += n


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return h.hexdigest()[:16]


def _target(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def _start(name: str):
    """Spawn nvcc for one source unless its library is already built;
    returns (target, process or None, tmp path)."""
    out = _target(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, proc, tmp


def _finish(name, out, proc, tmp) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names=SOURCES) -> None:
    """Compile every listed source that is not built yet, all at once."""
    with _lock:
        jobs = [(n, *_start(n)) for n in names]
        for job in jobs:
            _finish(*job)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def hmma_counts(name: str) -> dict | None:
    """HMMA (tensor-core) instructions in each kernel of the built library
    of ``csrc/<name>.cu``, from ``cuobjdump -sass``: ``{mangled kernel
    name: count}``, or None where the toolkit has no ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    library(name)
    text = subprocess.run([tool, "-sass", str(_target(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts: dict = {}
    kernel = None
    for line in text.splitlines():
        if "Function : " in line:
            kernel = line.split("Function : ", 1)[1].strip()
            counts[kernel] = 0
        elif kernel and "HMMA" in line:
            counts[kernel] += 1
    return counts


def body_attributes(name: str, entry: str, bodies) -> dict:
    """Registers and spilled (local) bytes a thread of each compiled body
    of ``csrc/<name>.cu``, through its ``entry(which, &regs, &local)``:
    ``{body: (regs, local)}`` in the order of ``bodies``."""
    fn = getattr(library(name), entry)
    fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    out = {}
    for which, body in enumerate(bodies):
        regs, local = ctypes.c_int(), ctypes.c_int()
        check(fn(which, ctypes.byref(regs), ctypes.byref(local)),
              f"{name} attributes")
        out[body] = (regs.value, local.value)
    return out
