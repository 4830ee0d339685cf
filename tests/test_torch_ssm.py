"""The port's state-space families (Mamba2, RWKV6, Zamba2) against the
reference.

Inputs are numpy arrays from a seed; block parameters come from the
reference's own initializers, whole models' weights reach the port through
``repro_torch.models.convert``.  Tolerances: the reference tests' own for
the scans (``tests/test_models.py``: 1e-4 for SSD and the associative WKV,
1e-5 for the chunked WKV) and for decode against forward (2e-3); 1e-5 for
single blocks and 1e-4 for whole models in float32, as in
``test_torch_layers.py`` and ``test_torch_models.py``.  The reference side
is jitted; its whole-model runs are computed once per config
(``_torch_zoo.reference``).  The zoo's forward, prefill/decode and
``generate`` twins of rwkv6 and zamba2 are in ``test_torch_models.py`` and
``test_torch_serve.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.mamba2 as RMB
import repro.models.rwkv6 as RRW
from repro.configs import get_arch as r_get_arch
from repro.models import get_model as r_get_model
import repro_torch.models.mamba2 as TMB
import repro_torch.models.rwkv6 as TRW
from repro_torch.configs import get_arch
from repro_torch.models import Mamba2Model, RWKV6Model, Zamba2Model, \
    get_model

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from _torch_zoo import (CPU, S, STEPS, check_port_init, close, close_cache,
                        inputs, port_model, reference, t)

KEY = jax.random.PRNGKey(0)
MAMBA = dict(shared_attn_every=0, family="ssm")   # zamba2's pure-SSM twin
# zamba2 with 2 sites over 4 layers, a tail of 1 and 2 shared blocks
ZAMBA_TAIL = dict(num_layers=5, num_shared_attn_blocks=2)


def _ssd_inputs(seed=0, B=2, S=64, H=3, P=8, N=5):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((B, S, H, P)).astype(f),
            rng.uniform(0.1, 1.0, (B, S, H)).astype(f),
            rng.uniform(0.3, 0.99, (B, S, H)).astype(f),
            rng.standard_normal((B, S, N)).astype(f),
            rng.standard_normal((B, S, N)).astype(f))


def _wkv_inputs(seed=1, B=2, S=48, H=3, P=8):
    rng = np.random.default_rng(seed)
    mk = lambda: rng.standard_normal((B, S, H, P)).astype(np.float32)  # noqa
    r, k, v = mk(), mk(), mk()
    w = rng.uniform(0.5, 0.99, (B, S, H, P)).astype(np.float32)
    u = rng.standard_normal((H, P)).astype(np.float32)
    m0 = rng.standard_normal((B, H, P, P)).astype(np.float32)
    return r, k, v, w, u, m0


def _params(tree):
    return jax.tree.map(lambda a: t(np.asarray(a)), tree)


# ------------------------------------------------------------------ scans
@pytest.mark.parametrize("chunk", [8, 16, 24, 64])
def test_ssd_chunked_matches_scan(chunk):
    """Twin of ``test_models.py::test_ssd_chunked_matches_scan``: the port's
    per-step oracle against the reference's, and the chunked form against
    both (24 does not divide 64: one chunk of S, the reference's rule),
    from a zero state and from a carried one."""
    x, dt, a, B_, C_ = _ssd_inputs()
    y0, h0 = TMB.ssd_scan_ref(*map(t, (x, dt, a, B_, C_)))
    ry0, rh0 = jax.jit(RMB.ssd_scan_ref)(x, dt, a, B_, C_)
    close(y0, ry0, 1e-4)
    close(h0, rh0, 1e-4)
    y1, h1 = TMB.ssd_chunked(*map(t, (x, dt, a, B_, C_)), chunk=chunk)
    ry1, rh1 = RMB.ssd_chunked(x, dt, a, B_, C_, chunk=chunk)
    for got, want in ((y1, y0), (h1, h0), (y1, ry1), (h1, rh1)):
        close(got, want, 1e-4)
    hin = np.random.default_rng(5).standard_normal(h0.shape).astype(
        np.float32)
    y2, h2 = TMB.ssd_chunked(*map(t, (x, dt, a, B_, C_)), chunk=chunk,
                             h0=t(hin))
    ry2, rh2 = RMB.ssd_chunked(x, dt, a, B_, C_, chunk=chunk,
                               h0=jnp.asarray(hin))
    close(y2, ry2, 1e-4)
    close(h2, rh2, 1e-4)


def test_ssd_chunked_keeps_the_input_dtype():
    """y comes back in x's dtype (bf16 here), the state in float32."""
    x, dt, a, B_, C_ = _ssd_inputs(S=32)
    y, h = TMB.ssd_chunked(t(x, torch.bfloat16), *map(t, (dt, a, B_, C_)),
                           chunk=16)
    ry, rh = RMB.ssd_chunked(jnp.asarray(x, jnp.bfloat16), dt, a, B_, C_,
                             chunk=16)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    close(y, ry, 2e-2)
    close(h, rh, 1e-4)


@pytest.mark.parametrize("with_m0", [True, False])
def test_wkv_variants_match(with_m0):
    """Twin of ``test_models.py::test_wkv_variants_match``: each of the
    port's three WKV forms against the reference's and against the port's
    per-step oracle, at the reference test's tolerances."""
    r, k, v, w, u, m0 = _wkv_inputs()
    m0 = m0 if with_m0 else None
    tm0 = t(m0) if with_m0 else None
    ours = {"scan": TRW.wkv_scan_ref(*map(t, (r, k, v, w, u)), m0=tm0),
            "assoc": TRW.wkv_associative(*map(t, (r, k, v, w, u)), m0=tm0),
            "chunked": TRW.wkv_chunked(*map(t, (r, k, v, w, u)), chunk=16,
                                       m0=tm0)}
    theirs = jax.jit(lambda *a: {
        "scan": RRW.wkv_scan_ref(*a, m0=m0),
        "assoc": RRW.wkv_associative(*a, m0=m0),
        "chunked": RRW.wkv_chunked(*a, chunk=16, m0=m0)})(r, k, v, w, u)
    tol = {"scan": 1e-5, "assoc": 1e-4, "chunked": 1e-5}
    for form, (y, M) in ours.items():
        close(y, theirs[form][0], tol[form])
        close(M, theirs[form][1], tol[form])
        close(y, ours["scan"][0], tol[form])
        close(M, ours["scan"][1], tol[form])
    if with_m0:                                  # the caller's m0 is kept
        np.testing.assert_array_equal(tm0.numpy(), m0)


def test_wkv_chunk_not_dividing_is_one_chunk():
    r, k, v, w, u, m0 = _wkv_inputs(S=20)
    y, M = TRW.wkv_chunked(*map(t, (r, k, v, w, u)), chunk=16, m0=t(m0))
    ry, rM = jax.jit(lambda *a: RRW.wkv_chunked(*a, chunk=16, m0=m0))(
        r, k, v, w, u)
    close(y, ry, 1e-5)
    close(M, rM, 1e-5)


# ----------------------------------------------------------------- blocks
@pytest.mark.parametrize("with_tail", [True, False])
def test_causal_conv_matches(with_tail):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    tail = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_tail else None
    y, nt = TMB.causal_conv(t(x), t(w), None if tail is None else t(tail))
    ry, rnt = RMB.causal_conv(x, w, tail)
    close(y, ry, 1e-5)
    close(nt, rnt, 0)


@pytest.mark.parametrize("scan_layers", [True, False])
def test_mamba_apply_matches(scan_layers):
    """A Mamba2 block over 128 tokens in chunks of 8 (or, with
    ``scan_layers`` off, the reference's cost-mode chunk of S // 8 = 16)."""
    cfg = get_arch("zamba2-1.2b").smoke().replace(scan_layers=scan_layers)
    rcfg = r_get_arch("zamba2-1.2b").smoke().replace(scan_layers=scan_layers)
    p = jax.tree.map(np.asarray, RMB.mamba_init(KEY, rcfg))
    x = np.random.default_rng(3).standard_normal((2, 128, 64)).astype(
        np.float32)
    y, h, tail = TMB.mamba_apply(_params(p), t(x), cfg, chunk=8)
    ry, rh, rtail = jax.jit(lambda p_, x_: RMB.mamba_apply(
        p_, x_, rcfg, chunk=8))(p, x)
    close(y, ry, 1e-5)
    close(h, rh, 1e-5)
    close(tail, rtail, 1e-5)


def test_mamba_decode_matches_and_updates_in_place():
    cfg = get_arch("zamba2-1.2b").smoke()
    rcfg = r_get_arch("zamba2-1.2b").smoke()
    p = jax.tree.map(np.asarray, RMB.mamba_init(KEY, rcfg))
    di, H, P, N = TMB.mamba_dims(cfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    h = rng.standard_normal((3, H, P, N)).astype(np.float32)
    tail = rng.standard_normal((3, cfg.conv_width - 1, di + 2 * N)).astype(
        np.float32)
    th, ttail = t(h), t(tail)
    y, h2, tail2 = TMB.mamba_decode(_params(p), t(x), th, ttail, cfg)
    ry, rh, rtail = RMB.mamba_decode(p, x, h, tail, rcfg)
    assert h2 is th and tail2 is ttail
    close(y, ry, 1e-5)
    close(th, rh, 1e-5)
    close(ttail, rtail, 1e-5)


@pytest.mark.parametrize("unroll", [False, True])
def test_timemix_apply_matches(unroll):
    """The chunked (``unroll`` off) and associative WKV inside the block."""
    cfg = get_arch("rwkv6-1.6b").smoke()
    rcfg = r_get_arch("rwkv6-1.6b").smoke()
    p = jax.tree.map(np.asarray, RRW.timemix_init(KEY, rcfg))
    p["u"] = np.random.default_rng(6).standard_normal(p["u"].shape).astype(
        np.float32)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 40, 64)).astype(np.float32)
    last = rng.standard_normal((2, 64)).astype(np.float32)
    y, lt, M = TRW.timemix_apply(_params(p), t(x), cfg, t(last), chunk=16,
                                 unroll=unroll)
    ry, rlt, rM = jax.jit(lambda p_, x_, l_: RRW.timemix_apply(
        p_, x_, rcfg, l_, chunk=16, unroll=unroll))(p, x, last)
    close(y, ry, 1e-5)
    close(lt, rlt, 0)
    close(M, rM, 1e-5)


def test_timemix_decode_matches_and_updates_in_place():
    cfg = get_arch("rwkv6-1.6b").smoke()
    rcfg = r_get_arch("rwkv6-1.6b").smoke()
    p = jax.tree.map(np.asarray, RRW.timemix_init(KEY, rcfg))
    p["u"] = np.random.default_rng(8).standard_normal(p["u"].shape).astype(
        np.float32)
    rng = np.random.default_rng(9)
    x, last = (rng.standard_normal((3, 64)).astype(np.float32)
               for _ in range(2))
    M = rng.standard_normal((3, 4, 16, 16)).astype(np.float32)
    tM = t(M)
    y, lt, M2 = TRW.timemix_decode(_params(p), t(x), cfg, t(last), tM)
    ry, rlt, rM = RRW.timemix_decode(p, x, rcfg, last, M)
    assert M2 is tM
    close(y, ry, 1e-5)
    close(lt, rlt, 0)
    close(tM, rM, 1e-5)


@pytest.mark.parametrize("ndim", [3, 2])
def test_chanmix_apply_matches(ndim):
    """The sequence branch (token shift inside) and the one-token branch."""
    rcfg = r_get_arch("rwkv6-1.6b").smoke()
    p = jax.tree.map(np.asarray, RRW.chanmix_init(KEY, rcfg))
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 7, 64) if ndim == 3 else (2, 64)).astype(
        np.float32)
    last = rng.standard_normal((2, 64)).astype(np.float32)
    y, nl = TRW.chanmix_apply(_params(p), t(x), t(last))
    ry, rnl = RRW.chanmix_apply(p, x, last)
    close(y, ry, 1e-5)
    close(nl, rnl, 0)


# ---------------------------------------------------------------- models
@pytest.mark.parametrize("arch,dtype", [
    ("rwkv6-1.6b", "float32"), ("rwkv6-1.6b", "bfloat16"),
    ("zamba2-1.2b", "float32"), ("zamba2-1.2b", "bfloat16"),
    ("mamba2", "float32")])
def test_port_init_matches_the_reference(arch, dtype):
    """The port's own init: the reference's names, shapes and dtypes (the
    float32 constants ``A_log``, ``D_skip``, ``dt_bias`` and ``u`` stay
    float32 in a bf16 model), its constants exactly (``mu`` 0.5, ``ln_x``,
    the norms and ``D_skip`` 1, ``A_log``, ``dt_bias`` and ``u`` 0), and
    its random weights' fan-in scale.  Zamba2 with 2 shared blocks; in
    float32 the reference's weights are the cached runs' own."""
    name, over = {"mamba2": ("zamba2-1.2b", MAMBA),
                  "zamba2-1.2b": ("zamba2-1.2b", ZAMBA_TAIL)}.get(
        arch, (arch, {}))
    cfg = get_arch(name).smoke().replace(**over, param_dtype=dtype,
                                         act_dtype=dtype)
    if dtype == "float32":
        ref = reference(name, decode=True, **over)["params"]
    else:
        rmodel = r_get_model(r_get_arch(name).smoke().replace(
            **over, param_dtype=dtype, act_dtype=dtype))
        ref = jax.tree.map(np.asarray, jax.jit(rmodel.init)(KEY))
    model = get_model(cfg, device=CPU).init(torch.Generator().manual_seed(0))
    check_port_init(model, ref)


@pytest.mark.parametrize("init", ["port", "reference"])
def test_decode_matches_forward_ssm(init):
    """Twin of ``test_models.py::test_decode_matches_forward_ssm`` (rwkv6):
    teacher-forced decode reproduces forward's logits (2e-3), on the
    port's own weights and on the reference's."""
    cfg = get_arch("rwkv6-1.6b").smoke()
    model = RWKV6Model(cfg, device=CPU).init(
        torch.Generator().manual_seed(0)) if init == "port" else \
        port_model("rwkv6-1.6b", reference("rwkv6-1.6b", decode=True))
    toks = t(inputs(cfg, seed=2, Bq=1, Sq=10))
    full = model.forward(toks)
    logits, cache = model.prefill(toks[:, :4])
    close(logits, full[:, 3], 2e-3)
    for i in range(4, 10):
        logits, cache = model.decode(cache, toks[:, i])
        close(logits, full[:, i], 2e-3)


@pytest.mark.parametrize("init", ["port", "reference"])
def test_decode_matches_forward_mamba(init):
    """Twin of ``test_models.py::test_decode_matches_forward_mamba``: the
    pure-Mamba2 model (zamba2's smoke config as the family ``ssm``)."""
    cfg = get_arch("zamba2-1.2b").smoke().replace(**MAMBA)
    model = Mamba2Model(cfg, device=CPU).init(
        torch.Generator().manual_seed(0)) if init == "port" else \
        port_model("zamba2-1.2b", reference("zamba2-1.2b", decode=True,
                                            **MAMBA), **MAMBA)
    toks = t(inputs(cfg, seed=3, Bq=1, Sq=8))
    full = model.forward(toks)
    logits, cache = model.prefill(toks[:, :3])
    close(logits, full[:, 2], 2e-3)
    for i in range(3, 8):
        logits, cache = model.decode(cache, toks[:, i])
        close(logits, full[:, i], 2e-3)


@pytest.mark.parametrize("arch,over", [
    ("zamba2-1.2b", MAMBA), ("zamba2-1.2b", ZAMBA_TAIL),
    ("rwkv6-1.6b", dict(scan_layers=False))],
    ids=["mamba2", "zamba2-tail", "rwkv6-unrolled"])
def test_variant_serving_matches_reference(arch, over):
    """Prefill and STEPS decode steps against the reference on its weights
    (1e-4): the pure-Mamba2 model; zamba2 with 2 sites, 2 shared blocks and
    a tail layer (at smoke size neither the round-robin nor the tail runs);
    RWKV6 with ``scan_layers`` off (the associative WKV in the prefill)."""
    ref = reference(arch, decode=True, **over)
    model = port_model(arch, ref, **over)
    logits, cache = model.prefill(t(ref["inputs"]), max_len=S + STEPS + 1)
    close(logits, ref["steps"][0][0], 1e-4)
    close_cache(cache, ref["steps"][0][1], 1e-4)
    for tok, (r_logits, r_cache) in zip(ref["tokens"], ref["steps"][1:]):
        logits, cache = model.decode(cache, t(tok))
        close(logits, r_logits, 1e-4)
        close_cache(cache, r_cache, 1e-4)
    if over is ZAMBA_TAIL:
        assert (model.n_sites, model.main, model.tail) == (2, 4, 1)
        assert model._site_params(1) is model.shared[1]


def test_zamba2_full_width_layout():
    """zamba2-1.2b: 6 sites over 36 layers and a tail of 2; the sites take
    the 2 shared blocks in turn (no weights are drawn)."""
    model = Zamba2Model(get_arch("zamba2-1.2b"), device=CPU)
    assert (model.n_sites, model.main, model.tail) == (6, 36, 2)
    assert [list(model._site_layers(s)) for s in (0, 5)] == [
        list(range(0, 6)), list(range(30, 36))]
    assert list(model._site_layers(None)) == [36, 37]
    with pytest.raises(ValueError, match="shared_attn_every"):
        Zamba2Model(get_arch("zamba2-1.2b").replace(shared_attn_every=0),
                    device=CPU)


def test_zamba2_decode_writes_its_caches_in_place():
    """A decode step keeps every cache tensor (the sites' K/V, the Mamba2
    states): it writes the new token's K/V at ``len`` and advances the
    states where they lie, with no copy of the cache."""
    ref = reference("zamba2-1.2b", decode=True, **ZAMBA_TAIL)
    model = port_model("zamba2-1.2b", ref, **ZAMBA_TAIL)
    logits, cache = model.prefill(t(ref["inputs"]), max_len=S + 2)
    before = {k: (v.data_ptr(), v.clone()) for k, v in cache.items()}
    _, after = model.decode(cache, logits.argmax(-1))
    for k in ("h", "conv", "k", "v"):
        assert after[k].data_ptr() == before[k][0], k
        assert not torch.equal(after[k], before[k][1]), k
    assert torch.equal(after["k"][:, :, S + 1:], before["k"][1][:, :, S + 1:])
    assert torch.equal(after["len"], before["len"][1] + 1)
