"""``dist.pipeline.pipeline_apply`` (A12.7) on 4 gloo ranks against the
sequential stages and against ``repro.dist.pipeline.pipeline_apply`` on 4
host devices (``tests/dist_workers.py torch-pipeline`` / ``jax-pipeline``),
the reference test's stage ``tanh(h @ w)`` at S = 4 over M = 6 and M = 2
microbatches (more and fewer than the stages), rtol 1e-4, atol 1e-5; and
on one rank, where the schedule is the stage alone."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from dist_workers import PIPE_CASES, pipe_inputs  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 300


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipe_ranks")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    script = os.path.join(ROOT, "tests", "dist_workers.py")
    procs = [subprocess.Popen(
        [sys.executable, script, "jax-pipeline", str(out / "ref.npz"), "4"],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)]
    procs += [subprocess.Popen(
        [sys.executable, script, "torch-pipeline", str(out), str(r), "4",
         str(out / "init")], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    try:
        for p in procs:
            text, _ = p.communicate(timeout=RANK_TIMEOUT)
            assert p.returncode == 0 and "OK" in text, text[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return (dict(np.load(out / "ref.npz")),
            [dict(np.load(out / f"pipe_rank{r}.npz")) for r in range(4)])


def _sequential(w, x):
    h = x.astype(np.float64)
    for s in range(w.shape[0]):
        h = np.tanh(h @ w[s])
    return h


@pytest.mark.parametrize("case", PIPE_CASES, ids=lambda c: f"S{c[0]}_M{c[1]}")
def test_pipeline_matches_sequential_and_the_reference(runs, case):
    ref, ranks = runs
    s, m = case
    w, x = pipe_inputs(s, m)
    key = f"{s}x{m}"
    want = _sequential(w, x)
    for r in range(4):  # every rank returns the result
        got = ranks[r][key]
        assert got.shape == x.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, ref[key], rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(got, ranks[0][key])
    np.testing.assert_allclose(ref[key], want, rtol=1e-4, atol=1e-5)


def test_pipeline_on_one_rank_is_the_stage(tmp_path):
    import torch.distributed as dist

    from repro_torch.dist.pipeline import pipeline_apply

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        w, x = pipe_inputs(1, 3)
        got = pipeline_apply(lambda p, h: torch.tanh(h @ p),
                             torch.from_numpy(w[0]), torch.from_numpy(x))
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(got.numpy(), _sequential(w, x), rtol=1e-6,
                               atol=1e-6)
