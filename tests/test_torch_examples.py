"""The port's six examples (``examples/torch/``: five ANN drivers and the
Wide & Deep retrieval) on the CPU, each a subprocess at a small size with
``--device cpu`` and torch on one thread: each exits 0 with its final OK
line.  The six start together (a module fixture) and each test reads its
own run.
"""
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
EXAMPLES = {
    "quickstart": ("REPRO_QUICKSTART_N", "quickstart OK"),
    "ann_serving": ("REPRO_SERVING_N", "ann_serving OK"),
    "streaming_ingest": ("REPRO_STREAMING_N", "streaming_ingest OK"),
    "distributed_search": ("REPRO_DISTRIBUTED_N", "distributed_search OK"),
    "pod_serving": ("REPRO_POD_N", "pod serving demo OK"),
    "recsys_retrieval": ("REPRO_RECSYS_N", "recsys_retrieval OK"),
}
SIZE = {"distributed_search": "2048"}    # a multiple of the grid's 4 shards
TIMEOUT = 300


@pytest.fixture(scope="module")
def runs():
    """name -> (exit code, output) of every example, started together."""
    procs = {}
    for name, (knob, _) in EXAMPLES.items():
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   OMP_NUM_THREADS="1", **{knob: SIZE.get(name, "1000")})
        procs[name] = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "examples", "torch",
                                          f"{name}.py"), "--device", "cpu"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    out = {}
    try:
        for name, p in procs.items():
            out[name] = (p.communicate(timeout=TIMEOUT)[0], p.returncode)
    finally:
        for p in procs.values():
            p.kill()
    return out


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs(runs, name):
    log, rc = runs[name]
    assert rc == 0, log
    assert log.rstrip().splitlines()[-1] == EXAMPLES[name][1], log


def test_examples_import_no_jax():
    """The port's examples speak only to the port."""
    for name in EXAMPLES:
        src = open(os.path.join(ROOT, "examples", "torch",
                                f"{name}.py")).read()
        assert "import jax" not in src and "from repro." not in src \
            and "import repro\n" not in src, name
