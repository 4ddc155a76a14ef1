"""Checkpointing: per-leaf ``.npy`` files and a JSON manifest, async,
atomic: the port's copy of the reference's ``train/checkpoint.py``.

  * atomic publish: a save writes ``<dir>/tmp-<step>``, renames it to
    ``<dir>/step_<step:08d>``, then replaces ``<dir>/latest``, so a save
    cut short never shows as a checkpoint;
  * async save: the state is copied to the host before :func:`save`
    returns (snapshot semantics), and a thread writes the files;
  * restore onto any device: arrays load on the host and go to the
    template's device (or ``device``);
  * the manifest carries the step and each leaf's key (its tree path, as
    ``jax.tree_util.keystr`` writes it: ``['params']['embed']``), file,
    shape and dtype.  It is JSON, where the reference writes msgpack; bf16
    is stored as uint16, as the reference stores it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

MANIFEST = "manifest.json"


def _leaf_path(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def _flatten(tree, path=()):
    """(path, leaf) in sorted key order, depth first."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (k,))
    else:
        yield path, tree


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _host(t: torch.Tensor):
    """A host copy of ``t`` as numpy, and the dtype's name: bf16 as its
    uint16 bits."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


class _SaveThread(threading.Thread):
    """The async write; :meth:`join` raises what the write raised."""

    def __init__(self, write):
        super().__init__(daemon=True)
        self._write, self.error = write, None

    def run(self):
        try:
            self._write()
        except BaseException as e:  # noqa: BLE001 - re-raised by join()
            self.error = e

    def join(self, timeout=None):
        super().join(timeout)
        if self.error is not None:
            raise self.error


def save(state, step: int, directory: str, *, async_save: bool = False):
    """Snapshot ``state`` (a nested dict of tensors) at ``step`` into
    ``directory``.  With ``async_save`` returns the writing thread (its
    ``join`` raises a failed write), else None once the files are
    published."""
    host = [(p, *_host(x)) for p, x in _flatten(state)]

    def write():
        os.makedirs(directory, exist_ok=True)
        tmp = os.path.join(directory, f"tmp-{step}")
        final = os.path.join(directory, f"step_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for i, (p, arr, dtype) in enumerate(host):
            np.save(os.path.join(tmp, _leaf_path(i)), arr)
            manifest["leaves"].append({
                "key": _keystr(p), "file": _leaf_path(i),
                "shape": list(arr.shape), "dtype": dtype})
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        with open(os.path.join(directory, "latest.tmp"), "w") as f:
            f.write(os.path.basename(final))
        os.replace(os.path.join(directory, "latest.tmp"),
                   os.path.join(directory, "latest"))

    if async_save:
        t = _SaveThread(write)
        t.start()
        return t
    write()
    return None


def latest_step(directory: str) -> int | None:
    latest = os.path.join(directory, "latest")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    return int(name.split("_")[-1])


def _unflatten(pairs):
    tree: dict = {}
    for path, leaf in pairs:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def restore(directory: str, template, *, step: int | None = None,
            device=None):
    """Load the checkpoint at ``step`` (None: the latest) into the
    structure of ``template``, each leaf on ``device`` (None: the
    template leaf's device).  Returns (state, step).  A leaf the
    checkpoint lacks raises ``KeyError``, a shape that differs from the
    template's ``ValueError``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    by_key = {m["key"]: m for m in manifest["leaves"]}
    out = []
    for p, tmpl in _flatten(template):
        m = by_key.get(_keystr(p))
        if m is None:
            raise KeyError(f"checkpoint missing leaf {_keystr(p)}")
        arr = np.load(os.path.join(path, m["file"]))
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"shape mismatch for {_keystr(p)}: ckpt "
                             f"{arr.shape} vs template {tuple(tmpl.shape)}")
        if m["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        out.append((p, t.to(tmpl.device if device is None else device)))
    if not isinstance(template, dict):
        return out[0][1], manifest["step"]
    return _unflatten(out), manifest["step"]
