"""The port's training against the reference: the train step, AdamW and
gradient compression.

Both packages start from the same state (the reference's, carried over by
``models.convert.load_reference_train_state``) on the same numpy batch.
One train step's loss is held within 1e-5, ``grad_norm`` within 1e-4 and
every gradient leaf within 1e-3 of its largest magnitude; AdamW fed the
reference's gradients gives its parameters, moments and master copy within
1e-6.  The reference side runs once per arch (``_torch_zoo``).  Also the
twins of ``tests/test_substrates.py``'s optimizer and compression tests.
"""

import numpy as np
import pytest
import torch
from tests._hypothesis_shim import given, settings, st

import jax.numpy as jnp
from repro.optim import adamw as r_adamw
from repro.optim import compression as r_comp
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.models import get_model
from repro_torch.models.convert import (by_param_name,
                                        load_reference_train_state)
from repro_torch.optim import AdamWConfig, adamw, compression
from repro_torch.training import steps as tsteps

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from _torch_zoo import (CPU, TRAIN_OPT, TRAIN_S, close, n, reference_train,
                        t)


def port_state(arch, state, **overrides):
    cfg = get_arch(arch).smoke().replace(**overrides)
    model = get_model(cfg, device=CPU)
    return model, load_reference_train_state(model, state)


def torch_batch(batch):
    return {k: t(v) for k, v in batch.items()}


def grads_of(model, batch):
    params = dict(model.named_parameters())
    loss = tsteps.build_loss_fn(model)(batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return loss, {k: torch.zeros_like(p) if g is None else g
                  for (k, p), g in zip(params.items(), grads)}


def close_leaves(got, expect, frac):
    """Each leaf's max |diff| within ``frac`` of its largest magnitude."""
    assert list(got) == list(expect)
    for k in expect:
        e, g = n(expect[k]), n(got[k])
        assert g.shape == e.shape, k
        bound = frac * max(np.abs(e).max(), 1e-30)
        assert np.abs(g - e).max() <= bound, (k, np.abs(g - e).max(), bound)


def close_state(state, expect, tol):
    for k in ("m", "v", "master"):
        for name in expect["opt"][k]:
            np.testing.assert_allclose(
                n(state["opt"][k][name]), n(expect["opt"][k][name]),
                rtol=tol, atol=tol, err_msg=f"{k} {name}")
    for name in expect["params"]:
        np.testing.assert_allclose(
            n(state["params"][name]), n(expect["params"][name]), rtol=tol,
            atol=tol, err_msg=name)
    assert int(state["opt"]["count"]) == int(expect["opt"]["count"])


def expected(arch, ref_state, **overrides):
    """The reference's state as the port's dicts (a model of its own)."""
    return port_state(arch, ref_state, **overrides)[1]


# ---------------------------------------------------------------- the step
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_smoke_forward_and_train_step(arch):
    """Twin of ``tests/test_models.py::test_arch_smoke_forward_and_train_
    step``, held to the reference's jitted step (its gradients and its
    AdamW update)."""
    ref = reference_train(arch)
    batch = torch_batch(ref["batch"])
    model, state = port_state(arch, ref["state0"])
    loss, grads = grads_of(model, batch)
    close(loss, ref["loss"], 1e-5)
    close_leaves(grads, by_param_name(model, ref["grads"]), 1e-3)

    opt = AdamWConfig(**TRAIN_OPT)
    _, metrics = tsteps.build_train_step(model, opt)(state, batch)
    close(metrics["loss"], ref["metrics"]["loss"], 1e-5)
    close(metrics["grad_norm"], ref["metrics"]["grad_norm"], 1e-4)
    close(metrics["lr"], ref["metrics"]["lr"], 1e-7)
    assert bool(torch.isfinite(metrics["loss"]))

    # AdamW on the reference's own gradients
    model, state = port_state(arch, ref["state0"])
    adamw.update(by_param_name(model, ref["grads"]), state["opt"],
                 state["params"], opt)
    close_state(state, expected(arch, ref["state1"]), 1e-6)


def test_microbatch_accumulates_in_float32():
    """``microbatch=2`` against the reference's ``lax.scan``: the loss,
    the norm of the mean gradient and the first moment (a tenth of the
    clipped mean gradient)."""
    arch = "stablelm-1.6b"
    ref = reference_train(arch, microbatch=2)
    model, state = port_state(arch, ref["state0"])
    step = tsteps.build_train_step(model, AdamWConfig(**TRAIN_OPT),
                                   microbatch=2)
    _, metrics = step(state, torch_batch(ref["batch"]))
    close(metrics["loss"], ref["metrics"]["loss"], 1e-5)
    close(metrics["grad_norm"], ref["metrics"]["grad_norm"], 1e-4)
    close_leaves(state["opt"]["m"],
                 expected(arch, ref["state1"])["opt"]["m"], 1e-3)


@pytest.mark.parametrize("arch,seq", [("stablelm-1.6b", 32),
                                      ("rwkv6-1.6b", 128),
                                      ("zamba2-1.2b", 32)])
def test_remat_changes_no_gradient(arch, seq):
    """``remat=True`` (each layer, and RWKV6's WKV chunks, recomputed in
    the backward; rwkv6 at two chunks of 64) gives the loss and gradients
    of the run without it."""
    ref = reference_train(arch)
    rng = np.random.default_rng(5)
    vocab = get_arch(arch).smoke().vocab_size
    batch = {k: t(rng.integers(0, vocab, (2, seq)).astype(np.int32))
             for k in ("inputs", "labels")}
    outs = []
    for remat in (False, True):
        model, _ = port_state(arch, ref["state0"], remat=remat)
        outs.append(grads_of(model, batch))
    (l0, g0), (l1, g1) = outs
    close(l1, l0, 1e-6)
    close_leaves(g1, g0, 1e-6)


def test_ssd_chunked_gradient_finite_over_a_long_chunk():
    """A 256-step chunk whose decays span more than e^88 (zamba2-1.2b's
    chunk at full width): the port's chunked SSD has the gradients of the
    reference's per-step scan (where the reference's own chunked form,
    which masks after its exp, gives NaN: ROADMAP §3)."""
    import jax

    from repro.models.mamba2 import ssd_scan_ref as r_scan
    from repro_torch.models.mamba2 import ssd_chunked

    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 256, 2, 4)).astype(np.float32)
    dt = rng.uniform(0.5, 0.9, (1, 256, 2)).astype(np.float32)
    a = np.exp(-dt)
    bm, cm = (rng.standard_normal((1, 256, 4)).astype(np.float32)
              for _ in range(2))
    args = [torch.from_numpy(v).requires_grad_() for v in (x, dt, a, bm, cm)]
    y, h = ssd_chunked(*args, chunk=256)
    (y.sum() + h.sum()).backward()
    ref = jax.grad(lambda *v: sum(o.sum() for o in r_scan(*v)),
                   argnums=(0, 1, 2, 3, 4))(x, dt, a, bm, cm)
    for got, want in zip(args, ref):
        assert bool(torch.isfinite(got.grad).all())
        want = np.asarray(want)
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=2e-3,
                                   atol=2e-3 * np.abs(want).max())


def test_train_step_updates_the_model_in_place():
    """The state's params are the model's parameters: a step moves both."""
    ref = reference_train("stablelm-1.6b")
    model, state = port_state("stablelm-1.6b", ref["state0"])
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    step = tsteps.build_train_step(model, AdamWConfig(**TRAIN_OPT))
    new, _ = step(state, torch_batch(ref["batch"]))
    assert new["params"] is state["params"]
    for k, p in model.named_parameters():
        assert p is new["params"][k]
        assert not torch.equal(p, before[k]), k
    assert int(new["opt"]["count"]) == 1


# ---------------------------------------------------------------- optimizer
def _toy_params(rng):
    return {"w": rng.standard_normal((8, 4)).astype(np.float32),
            "b": rng.standard_normal((4,)).astype(np.float32)}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_adamw_decreases_quadratic(rng):
    """Twin of ``test_substrates.py::test_adamw_decreases_quadratic``, and
    step for step the reference's parameters."""
    p0 = _toy_params(rng)
    cfg = AdamWConfig(lr=5e-2, weight_decay=0.0, warmup_steps=1,
                      total_steps=200)
    rcfg = r_adamw.AdamWConfig(lr=5e-2, weight_decay=0.0, warmup_steps=1,
                               total_steps=200)
    params = _torch(p0)
    state = adamw.init(params)
    rparams = {k: jnp.asarray(v) for k, v in p0.items()}
    rstate = r_adamw.init(rparams)

    def loss(p):
        return sum(((v - 1.0) ** 2).sum() for v in p.values())

    l0 = float(loss(params))
    for _ in range(100):
        grads = {k: 2 * (v - 1.0) for k, v in params.items()}
        params, state, _ = adamw.update(grads, state, params, cfg)
        rgrads = {k: 2 * (v - 1.0) for k, v in rparams.items()}
        rparams, rstate, _ = r_adamw.update(rgrads, rstate, rparams, rcfg)
    assert float(loss(params)) < 0.2 * l0
    for k in p0:
        close(params[k], rparams[k], 1e-5)


def test_adamw_no_master_close_to_master(rng):
    params = _toy_params(rng)
    pm, pn = _torch(params), _torch(params)
    sm = adamw.init(pm, use_master=True)
    sn = adamw.init(pn, use_master=False)
    assert "master" not in sn
    g = {k: 0.1 * torch.ones(v.shape) for k, v in params.items()}
    adamw.update(g, sm, pm, AdamWConfig(lr=1e-2, use_master=True))
    adamw.update(g, sn, pn, AdamWConfig(lr=1e-2, use_master=False))
    for k in params:
        np.testing.assert_allclose(pm[k].numpy(), pn[k].numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_grad_clipping_bounds_update(rng):
    params = _torch(_toy_params(rng))
    cfg = AdamWConfig(lr=1e-3, clip_norm=1.0)
    state = adamw.init(params)
    big = {k: 1e6 * torch.ones_like(v) for k, v in params.items()}
    before = {k: v.clone() for k, v in big.items()}
    _, _, metrics = adamw.update(big, state, params, cfg)
    assert float(metrics["grad_norm"]) > 1e5  # pre-clip norm reported
    rstate = r_adamw.init({k: jnp.asarray(v) for k, v in before.items()})
    _, _, rmetrics = r_adamw.update(
        {k: jnp.asarray(v.numpy()) for k, v in before.items()}, rstate,
        {k: jnp.zeros(v.shape) for k, v in before.items()},
        r_adamw.AdamWConfig(lr=1e-3, clip_norm=1.0))
    close(metrics["grad_norm"], rmetrics["grad_norm"], 1e-6)
    # the clipped moment: (1 - b1) * g / |g|, and the gradients untouched
    np.testing.assert_allclose(state["m"]["w"].numpy(), 0.1 / 6.0,
                               rtol=1e-5)          # 36 elements: |g| = 6e6
    for k in big:
        assert torch.equal(big[k], before[k])


def test_global_norm_accurate_on_a_large_tensor():
    """The clip norm over 2^25 elements (a sixth of stablelm-1.6b's
    embedding) within 1e-6 of float64 on the CPU, where torch's vector
    norm alone is off by far more; and equal to the reference's."""
    rng = np.random.default_rng(9)
    x = (rng.standard_normal(1 << 25) * 1e-3).astype(np.float32)
    y = rng.standard_normal((64, 3)).astype(np.float32)
    exact = np.sqrt((x.astype(np.float64) ** 2).sum()
                    + (y.astype(np.float64) ** 2).sum())
    got = float(adamw.global_norm([torch.from_numpy(x),
                                   torch.from_numpy(y)]))
    assert abs(got - exact) <= 1e-6 * exact
    ref = float(r_adamw.global_norm([jnp.asarray(x), jnp.asarray(y)]))
    assert abs(got - ref) <= 1e-6 * exact


def test_schedule_matches_reference():
    cfg = AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=50)
    rcfg = r_adamw.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=50)
    steps = np.arange(0, 60, dtype=np.int32)
    got = adamw.schedule(cfg, torch.from_numpy(steps))
    # the cosine of the two libraries may differ in its last bit
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(r_adamw.schedule(rcfg, steps)),
                               rtol=1e-6, atol=0)


# -------------------------------------------------------------- compression
@given(scale=st.floats(min_value=1e-6, max_value=1e4),
       n_=st.integers(min_value=1, max_value=500))
@settings(max_examples=50, deadline=None)
def test_quantize_roundtrip_error_bounded(scale, n_):
    rng = np.random.default_rng(42)
    g = (rng.standard_normal(n_) * scale).astype(np.float32)
    q, s = compression.quantize(torch.from_numpy(g))
    err = (compression.dequantize(q, s) - torch.from_numpy(g)).abs()
    assert float(err.max()) <= float(s) / 2 + 1e-12  # half-ULP of the grid


@pytest.mark.parametrize("scale", [1e-6, 1.0, 1e4])
def test_quantize_matches_reference(scale):
    g = (np.random.default_rng(7).standard_normal(300) * scale).astype(
        np.float32)
    q, s = compression.quantize(torch.from_numpy(g))
    rq, rs = r_comp.quantize(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    np.testing.assert_array_equal(compression.dequantize(q, s).numpy(),
                                  np.asarray(r_comp.dequantize(rq, rs)))


def test_error_feedback_unbiased_over_time(rng):
    """With EF, the accumulated applied gradient converges to the
    accumulated true gradient; every step's payload and error equal the
    reference's."""
    g = rng.standard_normal((64,)).astype(np.float32)
    err = compression.init_error({"g": torch.zeros(64)})["g"]
    rerr = jnp.zeros(64, jnp.float32)
    total = torch.zeros(64)
    for _ in range(50):
        comp, errs = compression.ef_compress({"g": torch.from_numpy(g)},
                                             {"g": err})
        rcomp, rerrs = r_comp.ef_compress({"g": jnp.asarray(g)},
                                          {"g": rerr})
        err, rerr = errs["g"], rerrs["g"]
        q, s = comp["g"]
        np.testing.assert_array_equal(q.numpy(), np.asarray(rcomp["g"][0]))
        np.testing.assert_allclose(err.numpy(), np.asarray(rerr), rtol=0,
                                   atol=1e-6)
        total = total + compression.dequantize(q, s)
    np.testing.assert_allclose((total / 50).numpy(), g, rtol=0.05,
                               atol=float(np.abs(g).max()) / 50)


def test_shared_scale_int8_sum_exact(rng):
    """The compressed pod sum's arithmetic, in torch: with a shared scale,
    the int16 sum of int8 payloads dequantizes to the exact sum of the
    quantized values."""
    gs = [torch.from_numpy(rng.standard_normal((32,)).astype(np.float32))
          for _ in range(4)]
    s = max(float(g.abs().max()) for g in gs) / 127.0 + 1e-12
    qs = [torch.clamp(torch.round(g / s), -127, 127).to(torch.int8)
          for g in gs]
    qsum = sum(q.to(torch.int16) for q in qs)
    deq = qsum.float().numpy() * s
    direct = sum(q.float().numpy() * s for q in qs)
    np.testing.assert_allclose(deq, direct, rtol=1e-5, atol=1e-6)


def test_compressed_pod_psum_waits_for_item_13():
    """``compressed_pod_psum`` (ROADMAP item 13a) over a one-rank ``pod``
    group: the mean of one pod is its own gradient quantized and
    dequantized, and the error its residual, exactly."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    rng = np.random.default_rng(13)
    grads = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for k, s in (("a", (8, 5)), ("b", (7,)))}
    error = {k: torch.from_numpy(rng.standard_normal(g.shape).astype(
        np.float32) * 1e-3) for k, g in grads.items()}
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("pod",))
        stats = {}
        mean, err = compression.compressed_pod_psum(grads, error, mesh,
                                                    stats=stats)
    finally:
        dist.destroy_process_group()
    for k, g in grads.items():
        q, s = compression.quantize(g + error[k])
        deq = compression.dequantize(q, s)
        assert torch.equal(stats["q"][k], q)
        assert torch.equal(mean[k], deq)
        assert torch.equal(err[k], g + error[k] - deq)
