"""The port's serving launcher (``python -m repro_torch.launch.serve``) on
the CPU, run in-process at ``--n 2000 --d 16 --batches 4 --device cpu``:

* its answers are ``Index.build(...).search``'s on the same batches;
* ``--router replicated:2 --kill-replica 1`` ends with ``lost_futures=0``;
* ``--mesh 2x2`` with ``--save-index`` and then ``--load-index`` answer
  alike, and the reload says its graphs are captured again;
* malformed ``--mesh`` and ``--router`` specs exit with the reference's
  messages.
"""
import sys

import numpy as np
import pytest
import torch

from repro_torch.ann import Index
from repro_torch.configs.base import ANNConfig
from repro_torch.data.synthetic import make_clustered
from repro_torch.launch import serve

# the plain versions are small here: one thread each, so the test
# workers running beside this file keep their cores
torch.set_num_threads(1)

SMALL = ["--n", "2000", "--d", "16", "--batches", "4", "--device", "cpu"]
SEARCH = Index.search


def _launch(monkeypatch, capsys, *flags):
    """Run the launcher with ``flags``: (stdout, [(Q, ids, dists)] of its
    searches)."""
    calls = []

    def recording(self, Q, *, k=None):
        out = SEARCH(self, Q, k=k)
        calls.append((np.array(Q), *out))
        return out

    monkeypatch.setattr(Index, "search", recording)
    monkeypatch.setattr(sys, "argv", ["serve", *SMALL, *flags])
    serve.main()
    return capsys.readouterr().out, calls


def test_launcher_answers_as_the_index(monkeypatch, capsys):
    out, calls = _launch(monkeypatch, capsys)
    assert "plane: single, device: cpu" in out
    assert "[serve] compiles=" in out and "weighted recall" in out
    ds = make_clustered(n=2000, d=16, n_queries=512, n_clusters=64,
                        noise=0.6)
    index = Index.build(ds.X, ANNConfig(), device="cpu")
    rng = np.random.default_rng(0)
    assert len(calls) == 4
    for Q, ids, dists in calls:
        B = int(rng.choice([1, 4, 16, 64, 256]))
        sel = rng.integers(0, len(ds.Q), B)
        assert np.array_equal(Q, ds.Q[sel])
        want = SEARCH(index, Q)
        assert np.array_equal(ids, want[0])
        assert np.array_equal(dists.view(np.uint32), want[1].view(np.uint32))


def test_launcher_chaos_drill_loses_nothing(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve", *SMALL, "--router",
                                      "replicated:2", "--kill-replica", "1",
                                      "--health-interval", "0.2"])
    serve.main()
    out = capsys.readouterr().out
    assert "[router] killed replica 'r1' at batch 2" in out
    last = [ln for ln in out.splitlines()
            if ln.startswith("[router] compiles=")]
    assert len(last) == 1 and "lost_futures=0" in last[0], out
    assert "aot_primed=0" in last[0]


def test_launcher_mesh_round_trip(monkeypatch, capsys, tmp_path):
    path = str(tmp_path / "ix")
    out, saved = _launch(monkeypatch, capsys, "--mesh", "2x2",
                         "--save-index", path)
    assert "[serve] mesh plane: {'data': 2, 'model': 2}" in out
    assert "plane: mesh" in out and "artifact written" in out
    out, loaded = _launch(monkeypatch, capsys, "--mesh", "2x2",
                          "--load-index", path, "--quantization", "int8")
    assert "--quantization ignored with --load-index" in out
    assert "plane=mesh, aot_primed=0, no rebuild; its graphs are " \
        "captured again" in out
    assert len(saved) == len(loaded) == 4
    for (Qa, ia, da), (Qb, ib, db) in zip(saved, loaded):
        assert np.array_equal(Qa, Qb)
        assert np.array_equal(ia, ib)
        assert np.array_equal(da.view(np.uint32), db.view(np.uint32))


@pytest.mark.parametrize("flags,message", [
    (("--mesh", "4xq"), "--mesh '4xq' must be 'D' or 'DxM' integers, e.g. "
                        "--mesh 4x2"),
    (("--mesh", "2x2x2"), "--mesh takes at most two axes (data[xmodel])"),
    (("--router", "replicatd:2"), "--router: unknown router mode "
                                  "'replicatd'"),
    (("--router", "sharded:x"), "--router: router spec 'sharded:x' must be "
                                "MODE:N"),
    (("--router", "replicated:2", "--kill-replica", "2"),
     "--kill-replica 2 out of range for 2 replicas"),
    (("--kill-replica", "0"),
     "--replica-endpoints/--kill-replica only apply with --router"),
])
def test_launcher_refuses_malformed_specs(monkeypatch, flags, message):
    monkeypatch.setattr(sys, "argv", ["serve", *SMALL, *flags])
    with pytest.raises(SystemExit) as e:
        serve.main()
    assert str(e.value).startswith(message), str(e.value)
