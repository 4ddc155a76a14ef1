"""The versioned on-disk index artifact (the reference's
``ann/artifact.py``).

Layout (a directory), the reference's own, so either package reads what
the other writes::

    <path>/
      manifest.json   magic, format version, plane, ANNConfig, k, runtime
                      fingerprint, mesh topology (sharded), regime
                      threshold, generation, sha256 per payload
      arrays.npz      single plane: X + the packed graph (neighbors /
                      lambdas / degrees [/ hubs]); with int8 residency the
                      codes and scales (format v4); on a packed index X and
                      the codes in packed order with ``perm`` beside them
                      (format v5)
      arrays/<i>.npz  mesh plane, shard-major: DB shard i's slice of X
                      and its OWN sub-index (the same names, ``hubs``
                      always, ``perm`` shard-local), one file and checksum
                      a shard
      streaming.npz   only with un-compacted mutations (format v3): the
                      tombstones (``np.packbits`` of the base mask) and the
                      delta shard's assigned rows and flags; the capacity
                      padding is not stored, the load re-pads

Formats 1-4 load as the reference loads them: v1/v2 are frozen indexes
at generation 0 (v1 predates the ``plane`` field), v3 has no int8 payload
(a quantized config derives the codes at install), v4 no ``perm`` (rows in
external order).

The reference also stores jax.export blobs of its serving executables
(``"aot"``).  The port's cache entries are CUDA graphs, bound to device
addresses, with no serialized form: a port artifact's ``"aot"`` list is
empty, and a reference artifact's blobs are skipped (a loaded index
captures its graphs at warmup or on first use).

Safety gates: a wrong ``magic`` or an unknown ``format_version`` and any
sha256 mismatch raise :class:`ArtifactError`.  Topology: a sharded
artifact loaded with ``mesh=`` of the same DB shard count re-binds the
saved sub-indexes bit for bit (inside a pod, :mod:`repro_torch.serve.pod`,
each rank reads and re-binds only its own shards onto a ``PodPlane``; a
pod saves SPMD, rank 0 writing, with ``plane: "pod"`` and
``topology.n_processes``); without ``mesh=`` it warns, gathers the
shards and rebuilds a single index; onto another shard count it warns
("topology mismatch") and rebuilds for the new cut; a single artifact
loaded with ``mesh=`` warns and reshards.  Every rebuild takes the rows
in external order (a packed artifact is un-permuted shard by shard), so
saved ids — the stream's tombstones too — stay valid.

``kernel_backend`` speaks two vocabularies.  The port writes the
reference's names in the config (``"cuda"`` -> ``"pallas"``, the
hand-written kernels; ``"torch"`` -> ``"xla"``, the plain path) so the
reference can load it, and keeps its own value beside the config
(``"torch_kernel_backend"``).  A reference artifact's ``"pallas"`` /
``"xla"`` load as ``"auto"``, with a warning: the loading device picks the
kernels (the card) or the plain path (the CPU).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import warnings
from pathlib import Path

import numpy as np

from repro_torch.configs.base import ANNConfig

FORMAT_VERSION = 5
# still-readable older revisions (1 = pre-plane single-device layout,
# 2 = no generation counter / streaming payload, 3 = no int8 codes,
# 4 = no locality permutation: rows in external order)
READ_VERSIONS = (1, 2, 3, 4, 5)
MAGIC = "repro-ann-index"
_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"
_STREAMING = "streaming.npz"
# the port's kernel_backend -> the reference's name for the same path
_TO_REFERENCE = {"auto": "auto", "cuda": "pallas", "torch": "xla"}


class ArtifactError(RuntimeError):
    """Unusable index artifact (bad magic or version, corruption)."""


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _config_to_dict(cfg: ANNConfig) -> dict:
    d = dataclasses.asdict(cfg)
    d["kernel_backend"] = _TO_REFERENCE[cfg.kernel_backend]
    return d


def _config_from_dict(d: dict, port_backend: str | None) -> ANNConfig:
    """ANNConfig from manifest JSON: tuple fields arrive as lists, unknown
    keys are dropped with a warning, and ``kernel_backend`` is the port's
    own where the port wrote the artifact, else ``"auto"``."""
    fields = {f.name for f in dataclasses.fields(ANNConfig)}
    kwargs, unknown = {}, []
    for name, val in d.items():
        if name not in fields:
            unknown.append(name)
            continue
        kwargs[name] = tuple(val) if isinstance(val, list) else val
    if unknown:
        warnings.warn(f"index artifact config has unknown fields {unknown}; "
                      "ignored", stacklevel=4)
    saved = kwargs.get("kernel_backend", "auto")
    if port_backend is not None:
        kwargs["kernel_backend"] = port_backend
    elif saved != "auto":
        warnings.warn(
            f"index artifact written with the reference's kernel_backend="
            f"{saved!r}; loaded as 'auto' (the hand-written kernels on the "
            "card, the plain PyTorch path on the CPU)", stacklevel=4)
        kwargs["kernel_backend"] = "auto"
    return ANNConfig(**kwargs)


# --------------------------------------------------------------------------
# save
# --------------------------------------------------------------------------

def save_index(index, path, *, aot: bool = True, extra_ks=()) -> Path:
    """Write ``index`` to ``path`` (a directory, created if needed).

    ``aot`` and ``extra_ks`` are the reference's: each ``k`` is validated
    against every warmup-reachable regime before anything is written, but
    no executable is stored (see the module docstring).  On a pod every
    rank calls it (the shards are gathered with a collective), rank 0
    alone writes, and all ranks meet at a barrier before returning."""
    eng = index.engine
    plane = eng.plane
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    writer = getattr(plane, "rank", 0) == 0
    kinds = {p[0] for p in eng.warmup_probes()}
    for k in sorted({index.k, *extra_ks}):  # fail fast, before any bytes
        for kind in kinds:
            eng._validate_k(k, kind)

    with eng.lock:  # one generation and one stream state
        manifest = {
            "magic": MAGIC,
            "format_version": FORMAT_VERSION,
            "plane": plane.name,
            "config": _config_to_dict(eng.cfg),
            "torch_kernel_backend": eng.cfg.kernel_backend,
            "k": index.k,
            "fingerprint": plane.fingerprint(),
            "calibrated_threshold": eng.threshold,
            "generation": int(eng.stats.generation),
        }
        stream = eng.stream
        if stream is not None and stream.dirty and writer:
            count = stream.delta.count
            np.savez(path / _STREAMING,
                     alive_bits=np.packbits(stream.base_alive),
                     n_base=np.int64(stream.n_base),
                     delta_X=stream.delta.X[:count],
                     delta_alive=stream.delta.alive[:count])
            manifest["streaming"] = {"file": _STREAMING,
                                     "sha256": _sha256(path / _STREAMING)}
        if plane.name in ("mesh", "pod"):
            manifest["topology"] = plane.topology()
            shards = plane.host_shards()  # a collective on a pod
            if writer:
                (path / "arrays").mkdir(exist_ok=True)
                entries = []
                for i, shard in enumerate(shards):
                    fname = f"arrays/{i}.npz"
                    np.savez(path / fname, **shard)
                    entries.append({"file": fname,
                                    "sha256": _sha256(path / fname)})
                manifest["arrays"] = entries
        else:
            g = plane.graph
            arrays = {"X": plane.X, "neighbors": g.neighbors,
                      "lambdas": g.lambdas, "degrees": g.degrees}
            if g.hubs is not None:
                arrays["hubs"] = g.hubs
            if plane.quantized:
                arrays["codes"], arrays["scales"] = plane.codes, plane.scales
            if g.perm is not None:  # v5: X / codes rows are in packed order
                arrays["perm"] = g.perm
            np.savez(path / _ARRAYS,
                     **{name: a.cpu().numpy() for name, a in arrays.items()})
            manifest["arrays"] = {"file": _ARRAYS,
                                  "sha256": _sha256(path / _ARRAYS)}
    if writer:
        manifest["aot"] = []
        (path / _MANIFEST).write_text(json.dumps(manifest, indent=2))
    if plane.name == "pod":
        plane.barrier()
    return path


# --------------------------------------------------------------------------
# load
# --------------------------------------------------------------------------

def _verified_npz(root: Path, entry: dict) -> dict:
    fpath = root / entry["file"]
    if not fpath.is_file():
        raise ArtifactError(f"missing payload {entry['file']}")
    if _sha256(fpath) != entry["sha256"]:
        raise ArtifactError(f"corrupt artifact: checksum mismatch in "
                            f"{entry['file']}")
    with np.load(fpath) as arrs:
        return {k: arrs[k] for k in arrs.files}


def _finish_load(index, path: Path, manifest: dict):
    """The saved generation counter and, when the artifact was saved with
    un-compacted mutations, the tombstones and the delta shard."""
    eng = index.engine
    eng.stats.generation = int(manifest.get("generation", 0))
    entry = manifest.get("streaming")
    if entry:
        arrs = _verified_npz(path, entry)
        n_base = int(arrs["n_base"])
        base_alive = np.unpackbits(
            arrs["alive_bits"], count=n_base).astype(bool)
        eng.restore_stream(base_alive, arrs["delta_X"], arrs["delta_alive"])
    return index


def load_index(index_cls, path, *, device=None, mesh=None):
    """Restore an `Index` saved by either package (formats 1-5) on
    ``device`` (default: the CUDA device) or, with ``mesh=``, on the
    grid's device; see the module docstring for the topology rules."""
    from repro_torch.ann.convert import graph_from_numpy
    from repro_torch.ann.layout import unpack_rows
    from repro_torch.device import resolve_device

    path = Path(path)
    mpath = path / _MANIFEST
    if not mpath.is_file():
        raise ArtifactError(f"{path} is not an index artifact "
                            f"(missing {_MANIFEST})")
    try:
        manifest = json.loads(mpath.read_text())
    except ValueError as e:
        raise ArtifactError(f"corrupt manifest in {path}: {e}") from e
    if manifest.get("magic") != MAGIC:
        raise ArtifactError(f"{path} is not a {MAGIC} artifact")
    ver = manifest.get("format_version")
    if ver not in READ_VERSIONS:
        raise ArtifactError(
            f"unsupported index artifact version {ver!r} "
            f"(this build reads versions {READ_VERSIONS})")
    saved_plane = manifest.get("plane", "single")
    cfg = _config_from_dict(manifest["config"],
                            manifest.get("torch_kernel_backend"))
    if manifest.get("aot"):
        warnings.warn(
            f"{len(manifest['aot'])} AOT executables in the artifact are "
            "skipped: the port captures CUDA graphs at warmup or on first "
            "use", stacklevel=3)
    k = manifest["k"]
    threshold = manifest.get("calibrated_threshold")
    if mesh is not None:
        if device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device={device} but the mesh is on "
                             f"{mesh.device}")
        device = mesh.device
    device = resolve_device(device)

    if saved_plane == "single":
        arrs = _verified_npz(path, manifest["arrays"])
        if mesh is not None:
            warnings.warn(
                "single-device artifact loaded with mesh=: resharding — "
                "the database is laid over the mesh and shard-local "
                "sub-indexes are REBUILT (the saved graph spans the whole "
                "database)", stacklevel=3)
            X = arrs["X"] if "perm" not in arrs \
                else unpack_rows(arrs["X"], arrs["perm"])
            return _finish_load(
                index_cls(X, cfg, k=k, mesh=mesh, threshold=threshold),
                path, manifest)
        graph = graph_from_numpy(
            arrs["neighbors"], arrs["lambdas"], arrs["degrees"],
            arrs.get("hubs"), arrs.get("perm"), device=device)
        # v4: re-bind the saved codes (earlier formats derive them at
        # install)
        quant = (arrs["codes"], arrs["scales"]) if "codes" in arrs else None
        index = index_cls(arrs["X"], cfg, k=k, graph=graph, quant=quant,
                          device=device, packed=True, threshold=threshold)
        return _finish_load(index, path, manifest)

    # ---- sharded (mesh or pod) artifact ---------------------------------
    entries = manifest["arrays"]
    topo = manifest.get("topology", {})
    from repro_torch.core import distributed as D
    from repro_torch.serve import pod

    if mesh is not None and pod.active() \
            and D.n_db_shards(mesh) == topo.get("n_db_shards"):
        # inside a pod, the same shard cut: each rank re-binds its own
        # shards, read from their own files
        world, rank = pod.world()
        per = len(entries) // world
        mine = [_verified_npz(path, e)
                for e in entries[rank * per:(rank + 1) * per]]
        plane = pod.PodPlane(None, cfg, mesh, local=True,
                             parts=tuple(_stacked(mine).values()))
        index = index_cls(None, cfg, k=k, plane=plane, threshold=threshold)
        return _finish_load(index, path, manifest)
    shards = [_verified_npz(path, e) for e in entries]
    full = _stacked(shards)

    def external_X():
        """The corpus in external row order, for the rebuilds."""
        if "perm" not in full:
            return full["X"]
        return unpack_rows(full["X"], full["perm"], n_shards=len(shards))

    if mesh is None:
        warnings.warn(
            f"sharded artifact ({topo.get('n_db_shards')} DB shards) "
            "loaded without mesh=: gathering shards and REBUILDING a "
            "single-device index (per-shard sub-indexes only search their "
            "own slice); pass mesh= to restore the sharded layout",
            stacklevel=3)
        return _finish_load(
            index_cls(external_X(), cfg, k=k, device=device,
                      threshold=threshold), path, manifest)

    from repro_torch.serve.plane import MeshPlane

    if D.n_db_shards(mesh) != topo.get("n_db_shards"):
        warnings.warn(
            f"mesh topology mismatch: artifact has "
            f"{topo.get('n_db_shards')} DB shards, requested mesh has "
            f"{D.n_db_shards(mesh)} — gathering and resharding (sub-"
            "indexes REBUILT for the new shard cut)", stacklevel=3)
        return _finish_load(
            index_cls(external_X(), cfg, k=k, mesh=mesh,
                      threshold=threshold), path, manifest)
    # the same shard cut: re-bind the saved sub-indexes, no rebuild
    plane = MeshPlane(None, cfg, mesh, parts=tuple(full.values()))
    index = index_cls(None, cfg, k=k, plane=plane, threshold=threshold)
    return _finish_load(index, path, manifest)


def _stacked(shards: list) -> dict:
    """Shard payloads concatenated row-wise, in the operand order the
    mesh plane takes: ``X, neighbors, lambdas, degrees, hubs`` [+ v4's
    ``codes, scales``] [+ v5's ``perm``]."""
    names = ("X", "neighbors", "lambdas", "degrees", "hubs")
    if "codes" in shards[0]:  # v4: the int8 payload
        names = names + ("codes", "scales")
    if "perm" in shards[0]:  # v5: rows shard-packed
        names = names + ("perm",)
    return {name: np.concatenate([s[name] for s in shards])
            for name in names}
