"""The landmark-sharded BA on the card (no JAX in this file: the card's
machine has none).

    python -m pytest -q -m gpu tests/test_torch_parallel_cuda.py

Two in-process shards of one card against the CPU port's two shards on
tests/test_torch_parallel.py's dense and PCG problems, and the
multi-process worker on the card: two ranks over gloo (NCCL refuses two
ranks on one card) and one rank over NCCL with two local shards.
"""

import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu_torch.parallel.multihost_worker import (
    build_problem, camera_fns)
from orb_slam3_study_kr_tpu_torch.parallel import (distributed_bundle_adjust,
                                                   make_ba_mesh)
from orb_slam3_study_kr_tpu_torch.parallel.dist_ba import shard_ba_problem
from test_torch_multihost import _run_cluster
from test_torch_parallel import _problems, _solve


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dense", "pcg"])
def test_two_shards_on_the_card_match_the_cpu(dev, name, monkeypatch):
    """2 shards of cuda:0 against 2 CPU shards: poses within 1e-4 (float32
    sums in another order on the card)."""
    import test_torch_parallel as tp
    p = _problems()[name]
    cpu = _solve(name, p, 2)
    monkeypatch.setattr(tp, "make_ba_mesh",
                        lambda devices: make_ba_mesh([dev] * len(devices)))
    card = _solve(name, p, 2)
    assert card["mesh"].devices == (dev, dev)
    np.testing.assert_allclose(card["R"], cpu["R"], atol=1e-4)
    np.testing.assert_allclose(card["t"], cpu["t"], atol=1e-4)


def _in_process(dev, n_iters=4, size=(12, 4096, 16384)):
    pr = build_problem(*size)
    parts = shard_ba_problem(2, pr["X0"], np.ones(size[1], np.float32),
                             pr["op"], pr["ol"], pr["ouv"], pr["olev"],
                             pr["omask"])
    put = lambda a: torch.as_tensor(a, device=dev)   # noqa: E731
    R, t, _, _ = distributed_bundle_adjust(
        make_ba_mesh([dev, dev]), *camera_fns(dev), put(pr["R0"]),
        put(pr["t0"]), put(pr["fixed"]), *map(put, parts[:7]),
        n_iters=n_iters, assembly="pcg")
    return R.cpu().numpy(), t.cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("backend,n_procs,shards",
                         [("gloo", 2, 1), ("nccl", 1, 2)])
def test_worker_on_the_card(dev, tmp_path, backend, n_procs, shards):
    """The worker at its default problem (4 LM iterations) on cuda:0: two
    gloo ranks with a shard each, or one NCCL rank with two shards; both
    converge and agree with an in-process 2-shard solve within 1e-4."""
    res, ranks = _run_cluster(n_procs, shards, tmp_path, n_iters=4,
                              device="cuda:0", backend=backend)
    assert res["backend"] == backend and res["device"] == "cuda:0"
    assert res["n_devices_global"] == 2 and res["psum_per_iter"] == 65
    assert res["pose_err"] < 0.05 and res["rot_err"] < 0.01, res
    R, t = _in_process(dev)
    for r in ranks:
        np.testing.assert_allclose(r["R"], R, atol=1e-4)
        np.testing.assert_allclose(r["t"], t, atol=1e-4)
        assert r["X"].shape == (4096, 3)
