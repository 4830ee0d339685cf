"""The port's model layers and MoE against the reference.

Inputs are numpy arrays from a seed; parameters come from the reference's
own initializers.  Tolerances are the reference tests' own where they have
one (``tests/test_models.py``: 1e-4 for blocked attention) and otherwise
set from float32's rounding: 1e-5 for single layers.  Reference calls are
jitted.  The whole models are in ``test_torch_models.py``, the serving path
in ``test_torch_serve.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as RL
import repro.models.moe as RM
from repro.kernels import ref as R_ref
import repro_torch.models.layers as TL
import repro_torch.models.moe as TM
from repro_torch.kernels import ref as T_ref

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from _torch_zoo import close, t

KEY = jax.random.PRNGKey(0)


# ---------------------------------------------------------------- layers
def test_rms_norm_matches(rng):
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    close(TL.rms_norm(t(x), t(w), 1e-5), RL.rms_norm(x, w, 1e-5), 1e-5)


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_apply_rope_matches(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 600, (2, 8)).astype(np.int32)
    close(TL.apply_rope(t(x), t(pos), theta),
          RL.apply_rope(x, jnp.asarray(pos), theta), 1e-5)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_apply_matches(gated):
    p = jax.tree.map(np.asarray, RL.mlp_init(KEY, 64, 128, gated))
    x = np.random.default_rng(2).standard_normal((3, 7, 64)).astype(
        np.float32)
    close(TL.mlp_apply({k: t(v) for k, v in p.items()}, t(x), gated),
          RL.mlp_apply(p, x, gated), 1e-5)


def _qkv(rng, Bq=2, Sq=64, H=4, hkv=2, d=16):
    return (rng.standard_normal((Bq, Sq, H, d)).astype(np.float32),
            rng.standard_normal((Bq, Sq, hkv, d)).astype(np.float32),
            rng.standard_normal((Bq, Sq, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("block_q", [16, 32, 64])
def test_blockwise_attention_matches(block_q):
    q, k, v = _qkv(np.random.default_rng(3))
    out = TL.blockwise_causal_attention(t(q), t(k), t(v), block_q=block_q)
    close(out, RL.blockwise_causal_attention(q, k, v, block_q=block_q), 1e-4)
    close(out, R_ref.causal_attention_ref(q, k, v), 1e-4)
    close(out, T_ref.causal_attention_ref(t(q), t(k), t(v)), 1e-4)


def test_causal_attention_ref_matches():
    q, k, v = _qkv(np.random.default_rng(4), Sq=24, H=6, hkv=3)
    close(T_ref.causal_attention_ref(t(q), t(k), t(v)),
          R_ref.causal_attention_ref(q, k, v), 1e-4)


def test_bidirectional_attention_matches():
    q, k, v = _qkv(np.random.default_rng(5))
    close(TL.blockwise_causal_attention(t(q), t(k), t(v), block_q=16,
                                        causal=False),
          RL.blockwise_causal_attention(q, k, v, block_q=16, causal=False),
          1e-4)


def _decode_inputs(seed, Bq=3, H=8, hkv=2, d=16, Smax=40):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((Bq, H, d)).astype(np.float32),
            rng.standard_normal((Bq, Smax, hkv, d)).astype(np.float32),
            rng.standard_normal((Bq, Smax, hkv, d)).astype(np.float32),
            np.array([1, 17, 40][:Bq], np.int32))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-2)])
def test_decode_attention_mirror_matches(dtype, tol):
    """The plain mirror rounds ``q * scale`` and p to the cache dtype as
    the reference does (bf16: to one output rounding)."""
    q, k, v, length = _decode_inputs(6)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = RL.decode_attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                              jnp.asarray(v, jd), jnp.asarray(length))
    out = TL.decode_attention(t(q, td), t(k, td), t(v, td), t(length))
    assert out.dtype == td
    close(out, ref, tol)


def test_decode_attention_kernel_path_matches_mirror():
    """Kernel 2's plain version (the model's path on the CPU) against the
    mirror, in float32."""
    from repro_torch.kernels.flash_attention import \
        flash_decode_attention_plain

    q, k, v, length = _decode_inputs(7)
    close(flash_decode_attention_plain(t(q), t(k), t(v), t(length)),
          TL.decode_attention(t(q), t(k), t(v), t(length)), 1e-5)


@pytest.mark.parametrize("bias", [False, True])
def test_attention_decode_apply_matches(bias):
    D, H, hkv, d, Smax = 64, 4, 2, 16, 24
    p = jax.tree.map(np.asarray, RL.attention_init(KEY, D, H, hkv, d, bias))
    if bias:
        rng = np.random.default_rng(8)
        p = {k: (rng.standard_normal(v.shape).astype(np.float32)
                 if k.startswith("b") else v) for k, v in p.items()}
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, D)).astype(np.float32)
    kc = rng.standard_normal((3, Smax, hkv, d)).astype(np.float32)
    vc = rng.standard_normal((3, Smax, hkv, d)).astype(np.float32)
    length = np.array([0, 9, 23], np.int32)
    kw = dict(n_heads=H, n_kv=hkv, head_dim=d, rope_theta=1e4)
    r_out, r_k, r_v = jax.jit(functools.partial(
        RL.attention_decode_apply, **kw))(p, x, kc, vc, jnp.asarray(length))
    tk, tv = t(kc), t(vc)
    out = TL.attention_decode_apply({k: t(v) for k, v in p.items()}, t(x),
                                    tk, tv, t(length), **kw)
    close(out, r_out, 1e-5)
    close(tk, r_k, 1e-5)
    close(tv, r_v, 1e-5)


def test_cache_update_writes_at_length(rng):
    """Twin of ``test_models.py::test_cache_update_writes_at_length``, and
    bit for bit the reference's values (a row past the cache is left
    alone, as the reference's one-hot leaves it)."""
    Bq, Smax, hkv, d = 4, 16, 2, 8
    new = rng.standard_normal((Bq, hkv, d)).astype(np.float32)
    base = rng.standard_normal((Bq, Smax, hkv, d)).astype(np.float32)
    lengths = np.array([0, 5, 15, 16], np.int32)
    for cache in (np.zeros_like(base), base):
        out = TL.cache_update(t(cache), t(new), t(lengths))
        ref = RL.cache_update(jnp.asarray(cache), jnp.asarray(new),
                              jnp.asarray(lengths))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        for b, l in enumerate(lengths[:3]):
            np.testing.assert_array_equal(out[b, l].numpy(), new[b])
            rest = np.delete(out[b].numpy(), l, axis=0)
            np.testing.assert_array_equal(rest, np.delete(cache[b], l,
                                                          axis=0))
        np.testing.assert_array_equal(out[3].numpy(), cache[3])


# -------------------------------------------------------------------- MoE
def _reference_kept(p, x, top_k, capacity_factor):
    """The reference's dispatch decisions: its router and ``lax.top_k``,
    then its capacity rule (stable sort by expert, first C per expert).
    Returns (G, Tg, k) bools."""
    G, Tg = x.shape[0], x.shape[1]
    E = p["router"].shape[1]
    probs = jax.nn.softmax(jnp.asarray(x, jnp.float32) @ p["router"], -1)
    _, eidx = jax.lax.top_k(probs, top_k)
    C = TM.capacity(Tg, top_k, E, capacity_factor)
    kept = np.zeros((G, Tg * top_k), bool)
    for g in range(G):
        fe = np.asarray(eidx[g]).reshape(-1)
        seen = np.zeros(E, int)
        for a in np.argsort(fe, kind="stable"):
            kept[g, a] = seen[fe[a]] < C
            seen[fe[a]] += 1
    return kept.reshape(G, Tg, top_k)


@pytest.mark.parametrize("capacity_factor", [2.0, 0.1])
@pytest.mark.parametrize("shared", [0, 1])
def test_moe_apply_matches(capacity_factor, shared):
    D, F, E, k = 16, 32, 8, 2
    p = jax.tree.map(np.asarray, RM.moe_init(KEY, D, F, E, shared))
    x = np.random.default_rng(10).standard_normal((2, 64, D)).astype(
        np.float32)
    ref = jax.jit(functools.partial(RM.moe_apply, top_k=k,
                                    capacity_factor=capacity_factor))(p, x)
    tp = {kk: ({a: t(b) for a, b in v.items()} if isinstance(v, dict)
               else t(v)) for kk, v in p.items()}
    stats = {}
    out = TM.moe_apply(tp, t(x), top_k=k, capacity_factor=capacity_factor,
                       stats=stats)
    close(out, ref, 1e-5)
    expect = _reference_kept(p, x, k, capacity_factor)
    np.testing.assert_array_equal(stats["kept"].numpy(), expect)
    if capacity_factor < 1:
        assert not expect.all()          # the small capacity drops some


def test_moe_capacity_drops_are_bounded(rng):
    """Twin of ``test_models.py::test_moe_capacity_drops_are_bounded``,
    on the port's own init."""
    D, F, E, k = 16, 32, 8, 2
    gen = torch.Generator().manual_seed(0)
    p = TM.moe_init(gen, D, F, E)
    x = torch.from_numpy(rng.standard_normal((2, 64, D)).astype(np.float32))
    y = TM.moe_apply(p, x, top_k=k, capacity_factor=2.0)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    y2 = TM.moe_apply(p, x, top_k=k, capacity_factor=0.1)
    assert bool(torch.isfinite(y2).all())
    assert float(y2.abs().mean()) <= float(y.abs().mean()) + 1e-6


def test_moe_groups_split_tokens():
    """``groups`` dispatches each group on its own, as the reference."""
    D, F, E, k = 16, 32, 8, 2
    p = jax.tree.map(np.asarray, RM.moe_init(KEY, D, F, E))
    x = np.random.default_rng(11).standard_normal((2, 32, D)).astype(
        np.float32)
    ref = jax.jit(functools.partial(RM.moe_apply, top_k=k,
                                    capacity_factor=0.5, groups=4))(p, x)
    out = TM.moe_apply({kk: t(v) for kk, v in p.items()}, t(x), top_k=k,
                       capacity_factor=0.5, groups=4)
    close(out, ref, 1e-5)
    with pytest.raises(ValueError, match="groups"):
        TM.moe_apply({kk: t(v) for kk, v in p.items()}, t(x), top_k=k,
                     groups=3)
