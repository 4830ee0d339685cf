"""The model zoo's steps on a (2, 4) (data, model) mesh of 8 gloo CPU
ranks, where each rank holds one query head of the smoke configs, and
sequence-parallel decode.

* The train step of llama3.2-3b and deepseek-moe-16b smoke (4 heads, 4 KV
  heads, ``weight_gather``, as the reference's ``tests/test_dryrun_smoke.py``
  lowers them on the same mesh) against the port's unsharded step from
  the same weights, at ``test_torch_sharded.py``'s 1e-5 (its 2x2 mesh
  holds two heads a rank), and their decode steps with the heads sharded.
* Decode on caches sharded along the sequence: the smoke configs' 2 KV
  heads do not divide the model axis of 4, so the rules give it to
  ``cache_seq``.  llama3.2-3b, deepseek-moe-16b and zamba2-1.2b on the
  reference's weights: ``build_prefill_step`` with ``cache_shardings``
  fills and places the cache, then decode steps; their logits and caches
  against the reference's, at 1e-5.  On the CPU kernel 2's passes run
  their plain versions, so no launch is counted.
* The sequence-parallel pieces on one process: a cache cut into slices,
  each slice's partials (``layers.seq_slice_partials``) folded by
  ``layers.seq_combine``, against the unsplit decode.
"""

import numpy as np
import pytest
import torch

from _torch_dist import run_ranks, seq_decode_rank, sharded_steps_rank
from _torch_zoo import S, STEPS, reference

TOL = 1e-5
TRAIN_ARCHS = ["llama3.2-3b", "deepseek-moe-16b"]
SEQ_ARCHS = ["llama3.2-3b", "deepseek-moe-16b", "zamba2-1.2b"]
DECODE_STEPS = 2


@pytest.fixture(scope="module")
def refs():
    return {a: reference(a, decode=True) for a in SEQ_ARCHS}


@pytest.fixture(scope="module")
def steps():
    """The train and head-sharded decode steps (fault 2's path)."""
    return run_ranks(sharded_steps_rank, 8, TRAIN_ARCHS, (2, 4), timeout=600)


@pytest.fixture(scope="module")
def seq(refs):
    """Prefill and decode on sequence-sharded caches (fault 1's path)."""
    cases = [(a, r["params"], r["inputs"],
              [np.asarray(t, np.int32) for t in r["tokens"][:DECODE_STEPS]])
             for a, r in refs.items()]
    return run_ranks(seq_decode_rank, 8, cases, (2, 4), S + STEPS + 1,
                     timeout=600)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_2x4_matches_unsharded(steps, arch):
    for rank in steps:
        r = rank[arch]
        l0, l1 = r["loss"]
        assert abs(l0 - l1) <= TOL * max(1.0, abs(l0)), (arch, l0, l1)
        assert r["param_err"] <= TOL, (arch, r["param_err"])
        assert r["opt_err"] <= TOL, (arch, r["opt_err"])
    # one query head a rank: wq's heads split four ways
    assert steps[0][arch]["placed"]["layers.0.attn.wq"] \
        == "(Shard(dim=0), Shard(dim=1))"


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_head_sharded_decode_on_2x4_matches_unsharded(steps, arch):
    for rank in steps:
        r = rank[arch]
        assert r["decode_err"] <= TOL, (arch, r["decode_err"])
        assert r["cache_err"] <= TOL, (arch, r["cache_err"])


@pytest.mark.parametrize("arch", SEQ_ARCHS)
def test_sequence_sharded_decode_matches_reference(seq, refs, arch):
    ref = refs[arch]
    for rank in seq:
        r = rank[arch]
        # batch rows on "data", the sequence on "model"
        assert r["placed"]["k"] == "(Shard(dim=1), Shard(dim=2))"
        assert r["launches"] == {"flash_partial": 0, "flash_combine": 0}
        assert len(r["steps"]) == DECODE_STEPS + 1
        for (logits, cache), (rl, rc) in zip(r["steps"], ref["steps"]):
            np.testing.assert_allclose(logits, rl, rtol=TOL, atol=TOL)
            assert set(cache) == set(rc)
            for k in rc:
                np.testing.assert_allclose(
                    cache[k].astype(np.float64), np.asarray(rc[k], np.float64),
                    rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("slices", [1, 2, 4, 8])
def test_slice_partials_fold_to_the_unsplit_decode(slices):
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models.layers import (cache_update, seq_combine,
                                           seq_slice_partials)

    g = torch.Generator().manual_seed(0)
    B, Smax, hkv, G, d = 3, 40, 2, 3, 16
    q = torch.randn(B, hkv * G, d, generator=g)
    kn, vn = (torch.randn(B, hkv, d, generator=g) for _ in range(2))
    k0, v0 = (torch.randn(B, Smax, hkv, d, generator=g) for _ in range(2))
    length = torch.tensor([0, 17, Smax - 1], dtype=torch.int32)
    k_all, v_all = k0.clone(), v0.clone()
    cache_update(k_all, kn, length)
    cache_update(v_all, vn, length)
    want = kfa.flash_decode_attention_plain(q, k_all, v_all, length + 1)
    n = Smax // slices
    ks, vs = k0.clone(), v0.clone()
    parts = [seq_slice_partials(q, kn, vn, ks[:, r * n:(r + 1) * n],
                                vs[:, r * n:(r + 1) * n], length, r)
             for r in range(slices)]
    out = seq_combine((torch.cat([p[0] for p in parts], -1),
                       torch.cat([p[1] for p in parts], -1),
                       torch.cat([p[2] for p in parts], -2)), q.dtype)
    assert torch.equal(ks, k_all) and torch.equal(vs, v_all)
    torch.testing.assert_close(out, want, rtol=TOL, atol=TOL)
    # a slice wholly past a row's length is exactly (NEG_INF, 0, 0)
    if slices > 1:
        m, l, acc = parts[-1]
        assert (m[0] == kfa.NEG_INF).all() and (l[0] == 0).all() \
            and (acc[0] == 0).all()
