"""The model zoo's steps on a 2x2 (data, model) mesh of gloo CPU ranks,
with the weights gathered at their point of use (``weight_gather``): one
train step and one decode step of llama3.2-3b, deepseek-moe-16b,
rwkv6-1.6b and zamba2-1.2b smoke (4 heads, 4 KV heads, as the reference's
``tests/test_dryrun_smoke.py`` lowers them), each held to the port's
unsharded step from the same weights within ``test_torch_train.py``'s
1e-5; and ``launch.train`` under the same four ranks against its run on
one device.  The unsharded steps are themselves held to the reference in
``test_torch_train.py`` and ``test_torch_serve.py``.
"""

import numpy as np
import pytest

from _torch_dist import (in_turn, run_ranks, sharded_steps_rank,
                         train_main_rank)

ARCHS = ["llama3.2-3b", "deepseek-moe-16b", "rwkv6-1.6b", "zamba2-1.2b"]
TOL = 1e-5


TRAIN_ARGV = ["--arch", "stablelm-1.6b", "--smoke", "--steps", "2",
              "--batch", "4", "--seq", "16", "--device", "cpu",
              "--log-every", "1"]


@pytest.fixture(scope="module")
def ranks():
    """One spawn of 4 ranks: the steps on a 2x2 mesh, then
    ``launch.train`` on ``make_local_mesh``'s."""
    return run_ranks(in_turn, 4, (sharded_steps_rank, (ARCHS, (2, 2))),
                     (train_main_rank, (TRAIN_ARGV,)), timeout=600)


@pytest.fixture(scope="module")
def steps(ranks):
    return [r[0] for r in ranks]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_unsharded(steps, arch):
    for rank in steps:
        r = rank[arch]
        l0, l1 = r["loss"]
        assert abs(l0 - l1) <= TOL * max(1.0, abs(l0)), (arch, l0, l1)
        assert r["param_err"] <= TOL, (arch, r["param_err"])
        assert r["opt_err"] <= TOL, (arch, r["opt_err"])
    # FSDP x TP: a weight with an "embed" and a "model" dim is 2-D sharded
    placed = steps[0][arch]["placed"]
    assert placed["top.lm_head"] == "(Shard(dim=0), Shard(dim=1))"
    assert placed["top.embed"] == "(Shard(dim=1), Shard(dim=0))"


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_step_matches_unsharded(steps, arch):
    for rank in steps:
        r = rank[arch]
        assert r["decode_err"] <= TOL, (arch, r["decode_err"])
        assert r["cache_err"] <= TOL, (arch, r["cache_err"])


def test_launch_train_under_four_ranks_matches_one_device(ranks):
    """``launch.train.main`` on 4 ranks: ``make_local_mesh``'s (1, 4)
    (data, model) mesh (the reference's rule gives the model axis 4 ranks
    where it can; smoke's 2 KV heads are then replicated over it), the
    weight gather on; its losses are the one-device run's."""
    from repro_torch.launch import train

    one = train.main(TRAIN_ARGV)
    for r in (r[1] for r in ranks):
        assert r["mesh"] == (1, 4) and r["names"] == ("data", "model")
        assert r["gather"]
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=TOL,
                                   atol=TOL)
    assert one["mesh"] is None and one["model"].weight_gather is None
