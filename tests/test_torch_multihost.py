"""The port's multi-process BA (parallel/multihost_worker.py over
torch.distributed with gloo) on the CPU.

Two spawned processes with two CPU shards each run one SPMD solve whose
reductions cross the process boundary; the same problem solved by one
process with four shards must agree.  The reference's default size runs
under ``-m slow``, as tests/test_multihost.py's two tests do."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ("--size", "6", "512", "2048")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_cluster(num_processes, shards, out_dir, n_iters=8, assembly="pcg",
                 extra=(), timeout=600, device="cpu", backend=None):
    """Run the worker as num_processes processes (gloo when several, unless
    ``backend`` is given); returns (rank 0's JSON line, every rank's
    arrays)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    if backend is None and num_processes > 1:
        backend = "gloo"
    backend = ("--backend", backend) if backend else ()
    procs = [subprocess.Popen(
        [sys.executable, "-m",
         "orb_slam3_study_kr_tpu_torch.parallel.multihost_worker",
         str(pid), str(num_processes), str(port), str(n_iters), assembly,
         "--device", device, "--shards-per-process", str(shards),
         "--out-dir", str(out_dir), *backend, *extra],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(num_processes)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(rc == 0 for rc, _, _ in outs), "\n".join(
        f"[proc {i} rc={rc}]\n{err[-3000:]}" for i, (rc, _, err) in enumerate(outs))
    res = json.loads(outs[0][1].strip().splitlines()[-1])
    ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
             for r in range(num_processes)]
    return res, ranks


def test_two_processes_match_one_process(tmp_path):
    """2 processes x 2 CPU shards over gloo against 1 process x 4 shards
    at K = 6, M = 512, O = 2048, 4 LM iterations: poses within 1e-4, the
    landmark table gathered on both ranks, n_cg + 5 reductions per
    iteration, and the reference's convergence walls."""
    res1, (one,) = _run_cluster(1, 4, tmp_path / "one", n_iters=4,
                                extra=SMALL)
    res2, ranks = _run_cluster(2, 2, tmp_path / "two", n_iters=4,
                               extra=SMALL)
    assert res2["n_processes"] == 2 and res2["n_devices_global"] == 4
    assert res1["n_devices_global"] == 4 and res2["backend"] == "gloo"
    assert res2["psum_per_iter"] == 65 and res1["psum_per_iter"] == 65
    for r in ranks:
        np.testing.assert_allclose(r["R"], one["R"], atol=1e-4)
        np.testing.assert_allclose(r["t"], one["t"], atol=1e-4)
        assert r["X"].shape == (512, 3)
        np.testing.assert_array_equal(r["X"], ranks[0]["X"])
    assert res2["pose_err"] < 0.05 and res2["rot_err"] < 0.01, res2


def test_worker_needs_a_backend_for_several_processes():
    """The worker never picks a backend itself: two processes without
    --backend are refused before anything runs."""
    from orb_slam3_study_kr_tpu_torch.parallel import multihost_worker
    with pytest.raises(SystemExit):
        multihost_worker.parse_args(["0", "2", "1234"])
    a = multihost_worker.parse_args(["0", "1", "1234"])
    assert a.backend is None and a.device == "cuda"
    assert a.n_iters == 10 and a.assembly == "pcg"


@pytest.mark.slow
def test_multiprocess_ba_two_hosts(tmp_path):
    """The reference's default problem (K = 12, M = 4096, O = 16384, 8
    iterations), 2 processes x 2 shards: converges to the ground truth."""
    res, ranks = _run_cluster(2, 2, tmp_path)
    assert res["n_processes"] == 2 and res["n_devices_global"] == 4
    assert res["pose_err"] < 0.05 and res["rot_err"] < 0.01, res
    assert res["X_shape"][0] % 4 == 0
    np.testing.assert_array_equal(ranks[0]["X"], ranks[1]["X"])


@pytest.mark.slow
def test_multiprocess_matches_single_process(tmp_path):
    """The reference's default problem, 1 process x 4 shards and 2
    processes x 2: the same optimum."""
    res1, (one,) = _run_cluster(1, 4, tmp_path / "one")
    res2, ranks = _run_cluster(2, 2, tmp_path / "two")
    assert res1["pose_err"] < 0.05 and res2["pose_err"] < 0.05
    assert abs(res1["pose_err"] - res2["pose_err"]) < 0.02
    np.testing.assert_allclose(ranks[0]["t"], one["t"], atol=1e-4)
