"""The port's pod plane (``serve/pod.py``) on the CPU: ranks over
``torch.distributed``'s gloo backend, held to the port's single-process
grid and to the JAX reference's shard-mapped search.

Data and config are the reference's ``tests/test_pod_plane.py``'s (n =
1,024, d = 16, two DB shards).  The 2-rank run is one module fixture: two
subprocesses join a pod over a ``file://`` rendezvous in ``tmp_path``,
build and serve the same pod index SPMD, save it (rank 0 writes), load it
back inside the pod, stream a round of adds and deletes and compact; each
writes its answers.  The tests then hold

* the ranks to each other (every rank materializes the same answer);
* the pod to the port's single-process (2, 1) grid, bit for bit, frozen,
  streamed and compacted;
* the pod to the reference's 2-shard ``make_search_fn`` on the pod's own
  saved arrays (one subprocess with two emulated devices, called
  directly as ``tests/test_torch_mesh.py`` calls it, never the
  reference's engine over a ``model`` axis): ids exactly, distances
  within 1e-6 * (qn + vn);
* the artifact: ``plane == "pod"``, ``n_processes == 2``, a
  single-process load warning ``"sharded artifact"``, and the 2-rank
  reload bit for bit.

A 1-rank pod needs no process group: it is tested in-process against the
single plane.
"""
import dataclasses
import inspect
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from repro_torch.ann import Index
from repro_torch.configs.base import ANNConfig
from repro_torch.core import distributed as D
from repro_torch.data.synthetic import make_clustered, recall_at_k
from repro_torch.serve.plane import get_plane, planes

# the plain versions are small here: one thread each, so the test
# workers running beside this file keep their cores
torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
KNOBS = dict(k_graph=8, max_degree=12, lambda0=4, bridge_hubs=16,
             bridge_k=4, large_ef=32, large_hops=16, serve_buckets=(8, 64))
TIMEOUT = 300   # seconds a subprocess may take before the test fails



def mutations(X):
    """The mutation round of every participant: 40 adds near the corpus,
    and the 20 base ids to delete (with every 7th added id, 1,038 rows
    stay: even, so the 2-shard grid compacts)."""
    rng = np.random.default_rng(7)
    V = X[rng.integers(0, len(X), 40)] \
        + 0.05 * rng.normal(size=(40, X.shape[1])).astype(np.float32)
    return V, np.arange(3, 1024, 51)[:20]


# each rank: argv = (rank, out dir, rendezvous file)
RANK = r"""
import dataclasses, json, sys, warnings
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.serve import pod
rank, out, rdv = int(sys.argv[1]), sys.argv[2], sys.argv[3]
pod.init_pod("file://" + rdv, world_size=2, rank=rank, device="cpu")
pod.init_pod("file://" + rdv, world_size=2, rank=rank, device="cpu")  # no-op
from repro_torch.ann import Index
from repro_torch.configs.base import ANNConfig
from repro_torch.core import distributed as D
from repro_torch.data.synthetic import make_clustered
# @MUTATIONS@
ds = make_clustered(n=1024, d=16, n_queries=64, n_clusters=16, noise=0.6,
                    seed=0)
cfg = dataclasses.replace(ANNConfig(), **KNOBS)
THR = 8.0 * cfg.small_t0
res = {}
try:
    pod.PodPlane(ds.X, cfg, D.make_mesh((1, 2), ("data", "model"),
                                        device="cpu"))
    res["model_axis"] = "accepted"
except ValueError as e:
    res["model_axis"] = str(e)
plane = pod.PodPlane(ds.X, cfg)
res["topology"], res["fingerprint_n"] = (plane.topology(),
                                         plane.fingerprint()["n_processes"])
res["local_rows"] = int(plane.X.shape[0])
idx = Index(None, cfg, k=10, plane=plane, threshold=THR)
ans = {}
for B in (5, 64):
    ans[f"frozen_{B}"] = idx.search(ds.Q[:B])
compiles = idx.stats.compiles
again = idx.search(ds.Q[:5])
res["repeat_compiles"] = idx.stats.compiles - compiles
res["repeat_equal"] = bool(np.array_equal(again[0], ans["frozen_5"][0]))
idx.save(out + "/pod_ix")
mesh = D.make_mesh((2,), ("data",), device="cpu")
loaded = Index.load(out + "/pod_ix", mesh=mesh)
res["loaded_plane"] = loaded.plane.name
for B in (5, 64):
    ans[f"loaded_{B}"] = loaded.search(ds.Q[:B])
V, del_base = mutations(ds.X)
new = idx.add(V)
idx.delete(del_base)
idx.delete(new[::7])
res["new_ids"] = new.tolist()
for B in (5, 64):
    ans[f"stream_{B}"] = idx.search(ds.Q[:B])
ans["stream_self"] = idx.search(V)
id_map = idx.compact()
res["id_map"] = id_map.tolist()
for B in (5, 64):
    ans[f"compact_{B}"] = idx.search(ds.Q[:B])
np.savez(f"{out}/rank{rank}.npz",
         **{f"{k}_ids": v[0] for k, v in ans.items()},
         **{f"{k}_dists": v[1] for k, v in ans.items()})
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump(res, f)
pod.close_pod()
print("RANK OK", rank)
""".replace("**KNOBS", ", ".join(f"{k}={v!r}" for k, v in KNOBS.items())) \
    .replace("# @MUTATIONS@", inspect.getsource(mutations))

# the reference: argv = (artifact dir, npz out); its 2-shard search on the
# pod's saved arrays
REFERENCE = r"""
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_arch
from repro.core import distributed as D
from repro.data.synthetic import make_clustered
art, out_path = sys.argv[1], sys.argv[2]
mesh = jax.make_mesh((2,), ("data",))
ds = make_clustered(n=1024, d=16, n_queries=64, n_clusters=16, noise=0.6,
                    seed=0)
cfg = dataclasses.replace(get_arch("tsdg-paper"), **KNOBS,
                          kernel_backend="xla")
shards = [np.load(f"{art}/arrays/{i}.npz") for i in range(2)]
cat = {n: np.concatenate([s[n] for s in shards])
       for n in ("X", "neighbors", "lambdas", "degrees", "hubs")}
sh = lambda *s: NamedSharding(mesh, P(*s))
ops = [jax.device_put(cat[n], sh("data", None) if cat[n].ndim == 2
                      else sh("data"))
       for n in ("X", "neighbors", "lambdas", "degrees", "hubs")]
out = {}
for kind, B in (("small", 5), ("large", 64)):
    fn = D.make_search_fn(mesh, cfg, kind=kind, k=10)
    ids, dist = fn(*ops, jax.device_put(jnp.asarray(ds.Q[:B]),
                                        sh(None, None)))
    out[f"{B}_ids"], out[f"{B}_dists"] = np.asarray(ids), np.asarray(dist)
np.savez(out_path, **out)
""".replace("**KNOBS", ", ".join(f"{k}={v!r}" for k, v in KNOBS.items()))


def _env(**extra):
    return dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1", **extra)


@pytest.fixture(scope="module")
def data():
    return make_clustered(n=1024, d=16, n_queries=64, n_clusters=16,
                          noise=0.6, seed=0)


@pytest.fixture(scope="module")
def cfg():
    return dataclasses.replace(ANNConfig(), **KNOBS)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The 2-rank pod, run once: its answers (rank -> {name: array}),
    its records and the output directory."""
    out = tmp_path_factory.mktemp("pod")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(out), str(out / "rdv")],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RANK OK {r}" in log, log
    answers = []
    for r in range(2):
        with np.load(out / f"rank{r}.npz") as z:
            answers.append({k: z[k] for k in z.files})
    records = [json.loads((out / f"rank{r}.json").read_text())
               for r in range(2)]
    return {"answers": answers, "records": records, "out": out}


def _pair(ans, name):
    return ans[f"{name}_ids"], ans[f"{name}_dists"]


def _bitwise(a, b) -> bool:
    return bool(np.array_equal(a[0], b[0])) and bool(np.array_equal(
        np.asarray(a[1]).view(np.uint32), np.asarray(b[1]).view(np.uint32)))


# ----------------------------------------------------------------------
# one process
# ----------------------------------------------------------------------

def test_pod_plane_lazy_registration():
    assert get_plane("pod") is not None
    assert "pod" in planes()


def test_pod_plane_single_process_matches_single_device(data, cfg):
    """A 1-rank pod is a 1-DB-shard grid, which is the single plane bit
    for bit: ids and distance bits at B = 5 and 64."""
    thr = 8.0 * cfg.small_t0
    plane = get_plane("pod")(data.X, cfg, device="cpu")
    assert plane.name == "pod"
    assert plane.topology()["n_processes"] == 1
    pi = Index(None, cfg, k=10, plane=plane, threshold=thr)
    si = Index.build(data.X, cfg, k=10, threshold=thr, device="cpu")
    for B in (5, 64):
        assert _bitwise(pi.search(data.Q[:B]), si.search(data.Q[:B])), B


# ----------------------------------------------------------------------
# two ranks over gloo
# ----------------------------------------------------------------------

def test_pod_refuses_a_model_axis_and_describes_itself(run):
    for r, rec in enumerate(run["records"]):
        assert "'model'" in rec["model_axis"], rec["model_axis"]
        assert rec["topology"] == {"axes": {"data": 2}, "n_db_shards": 2,
                                   "n_q_shards": 1, "n_processes": 2}
        assert rec["fingerprint_n"] == 2
        assert rec["local_rows"] == 512     # each rank holds its shard
        # a repeated bucket makes no cache entry and answers alike
        assert rec["repeat_compiles"] == 0 and rec["repeat_equal"]


def test_pod_ranks_answer_alike(run):
    a, b = run["answers"]
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].tobytes() == b[name].tobytes(), name


def test_pod_equals_the_single_process_grid(run, data, cfg):
    """The pod against the port's (2, 1) grid over the same rows, bit for
    bit: frozen, after the same mutations, and after compact()."""
    ans = run["answers"][0]
    thr = 8.0 * cfg.small_t0
    grid = Index.build(data.X, cfg, k=10, threshold=thr,
                       mesh=D.make_mesh((2, 1), ("data", "model"),
                                        device="cpu"))
    for B in (5, 64):
        assert _bitwise(_pair(ans, f"frozen_{B}"),
                        grid.search(data.Q[:B])), B
    V, del_base = mutations(data.X)
    new = grid.add(V)
    assert new.tolist() == run["records"][0]["new_ids"]
    grid.delete(del_base)
    grid.delete(new[::7])
    for B in (5, 64):
        assert _bitwise(_pair(ans, f"stream_{B}"),
                        grid.search(data.Q[:B])), B
    assert _bitwise(_pair(ans, "stream_self"), grid.search(V))
    id_map = grid.compact()
    assert id_map.tolist() == run["records"][0]["id_map"]
    for B in (5, 64):
        assert _bitwise(_pair(ans, f"compact_{B}"),
                        grid.search(data.Q[:B])), B


def test_pod_stream_round(run):
    """No deleted id comes back; every live added row finds itself first."""
    ans, rec = run["answers"][0], run["records"][0]
    new = np.asarray(rec["new_ids"])
    dead = np.concatenate([np.arange(3, 1024, 51)[:20], new[::7]])
    for name in ("stream_5", "stream_64", "stream_self"):
        assert not np.isin(ans[f"{name}_ids"], dead).any(), name
    live = np.setdiff1d(np.arange(len(new)), np.arange(0, len(new), 7))
    assert (ans["stream_self_ids"][live, 0] == new[live]).all()
    id_map = np.asarray(rec["id_map"])
    assert (id_map[dead] == -1).all()
    assert id_map.max() == 1024 + 40 - len(dead) - 1


def test_pod_equals_the_reference_search(run, data):
    """The reference's 2-shard shard-mapped search on the arrays the pod
    saved: ids exactly, distances within 1e-6 * (qn + vn)."""
    out = run["out"]
    env = _env(JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2 "
               "--xla_backend_optimization_level=0 "
               "--xla_llvm_disable_expensive_passes=true")
    r = subprocess.run([sys.executable, "-c", REFERENCE,
                        str(out / "pod_ix"), str(out / "ref.npz")],
                       env=env, capture_output=True, text=True,
                       timeout=TIMEOUT)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    ans = run["answers"][0]
    rows = data.X.astype(np.float64)
    with np.load(out / "ref.npz") as ref:
        for B in (5, 64):
            want_i, want_d = ref[f"{B}_ids"], ref[f"{B}_dists"]
            ids, dists = _pair(ans, f"frozen_{B}")
            np.testing.assert_array_equal(ids, want_i)
            qn = (data.Q[:B].astype(np.float64) ** 2).sum(1)[:, None]
            vn = (rows ** 2).sum(1)[want_i]
            err = np.abs(dists.astype(np.float64) - want_d)
            assert (err <= 1e-6 * (qn + vn)).all(), B


def test_pod_artifact(run, data):
    """The pod's artifact names its plane and processes; a plain
    single-process load warns, gathers and rebuilds (recall kept); the
    2-rank reload answered bit for bit."""
    path = run["out"] / "pod_ix"
    man = json.loads((path / "manifest.json").read_text())
    assert man["plane"] == "pod"
    assert man["topology"]["n_processes"] == 2
    assert man["topology"]["n_db_shards"] == 2
    assert len(man["arrays"]) == 2
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        loaded = Index.load(path, device="cpu")
    assert any("sharded artifact" in str(x.message) for x in w)
    assert loaded.plane.name == "single"
    r = recall_at_k(loaded.search(data.Q)[0], data.gt, 10)
    assert r > 0.8, r
    for rec, ans in zip(run["records"], run["answers"]):
        assert rec["loaded_plane"] == "pod"
        for B in (5, 64):
            assert _bitwise(_pair(ans, f"loaded_{B}"),
                            _pair(ans, f"frozen_{B}")), B
