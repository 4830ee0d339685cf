"""The reference's smoke models, run once per arch, and their weights in the
port: shared by ``test_torch_models.py`` and ``test_torch_serve.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as r_get_arch
from repro.models import get_model as r_get_model
from repro_torch.configs import get_arch
from repro_torch.models import get_model
from repro_torch.models.convert import load_reference_params

CPU = "cpu"
KEY = jax.random.PRNGKey(0)
TRANSFORMER_ARCHS = ["qwen2.5-3b", "codeqwen1.5-7b", "stablelm-1.6b",
                     "llama3.2-3b", "internvl2-26b", "hubert-xlarge",
                     "qwen3-moe-235b-a22b", "deepseek-moe-16b"]
SSM_ARCHS = ["rwkv6-1.6b", "zamba2-1.2b"]      # the families ssm, hybrid
ARCHS = TRANSFORMER_ARCHS + SSM_ARCHS
CAUSAL_ARCHS = [a for a in ARCHS if get_arch(a).causal]
B, S, STEPS = 2, 16, 3


def t(x, dtype=None):
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def n(x):
    return np.asarray(x.detach().float().numpy()
                      if isinstance(x, torch.Tensor) else x, np.float32)


def close(a, b, tol):
    np.testing.assert_allclose(n(a), n(b), rtol=tol, atol=tol)


def inputs(cfg, seed=0, Bq=B, Sq=S):
    """Prompt tokens, or frontend embeddings for a stub-frontend arch."""
    rng = np.random.default_rng(seed)
    if cfg.embedding_input:
        return rng.standard_normal((Bq, Sq, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (Bq, Sq)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def reference(arch, decode: bool = False, **overrides):
    """The reference's smoke model (with ``overrides`` of its config) on
    seed-0 weights, in one jitted call: params and the forward logits
    (numpy); with ``decode``, the prefill (room for STEPS + 1 more tokens)
    and STEPS greedy decode steps, each (logits, cache), and the tokens fed
    to them."""
    cfg = r_get_arch(arch).smoke().replace(**overrides)
    model = r_get_model(cfg)

    def run(key, x):
        params = model.init(key)
        out = {"params": params}
        if not decode:
            out["forward"] = model.forward(params, x)
            return out
        logits, cache = model.prefill(params, x, max_len=S + STEPS + 1)
        steps, toks = [(logits, cache)], []
        for _ in range(STEPS):
            toks.append(jnp.argmax(logits, axis=-1))
            logits, cache = model.decode(params, cache, toks[-1])
            steps.append((logits, cache))
        out.update(steps=steps, tokens=toks)
        return out

    x = inputs(cfg)
    out = jax.tree.map(np.asarray, jax.jit(run)(KEY, x))
    out["inputs"] = x
    return out


def port_model(arch, ref, **overrides):
    """The port's smoke model of ``arch`` (its family's class, with
    ``overrides`` of the config) on the reference's weights."""
    cfg = get_arch(arch).smoke().replace(**overrides)
    return load_reference_params(get_model(cfg, device=CPU), ref["params"])


def close_cache(cache, ref, tol):
    """The port's cache against the reference's: the same keys, ``len``
    equal, every state tensor within ``tol``."""
    assert set(cache) == set(ref)
    for k in ref:
        if k == "len":
            np.testing.assert_array_equal(cache[k].numpy(), ref[k])
        else:
            close(cache[k], ref[k], tol)


def check_port_init(model, ref_params):
    """The port's own init against the reference's (same config): the same
    names, shapes and dtypes; a constant (norms, biases, mix and decay
    constants) equal to the reference's exactly; a random weight cut at
    two standard deviations of its fan-in scale."""
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref_params)[0]:
        flat[".".join(str(p.key) for p in path)] = leaf
    seen = set()
    for name, p in model.named_parameters():
        p = p.detach()
        if name.startswith(("layers.", "shared.")):
            stack, i, rest = name.split(".", 2)
            key = f"{stack}.{rest}"
            r = flat[key][int(i)]
        else:
            key = name.split(".", 1)[1]
            r = flat[key]
        seen.add(key)
        assert tuple(p.shape) == r.shape, name
        assert str(p.dtype).split(".")[1] == r.dtype.name, name
        if (r == r.flat[0]).all():
            np.testing.assert_array_equal(n(p), n(r), err_msg=name)
            continue
        fan_in = p.shape[-1] if name.endswith("embed") else p.shape[-2]
        std = 1.0 / np.sqrt(fan_in)
        cut = 2 * std * (1 + max(1e-6, torch.finfo(p.dtype).eps))
        assert float(p.abs().max()) <= cut, name
        assert 0.7 * std < float(p.float().std()) < 1.0 * std, name
    assert seen == set(flat)


# ------------------------------------------------------------------ training
TRAIN_B, TRAIN_S = 2, 32          # the reference test's train-step shape
# warmup 1: the first step runs at the full learning rate
TRAIN_OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10)


def train_batch(cfg, seed=1):
    rng = np.random.default_rng(seed + 100)
    return {"inputs": inputs(cfg, seed, TRAIN_B, TRAIN_S),
            "labels": rng.integers(0, cfg.vocab_size,
                                   (TRAIN_B, TRAIN_S)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def reference_train(arch, microbatch: int = 1, **overrides):
    """The reference's smoke train state on seed-0 weights (``state0``) and
    its jitted train step on :func:`train_batch`: the new state and the
    metrics (``state1``, ``metrics``), all from one jitted call (numpy
    leaves).  Without microbatches the step is the reference's
    ``build_train_step`` body spelled out, so that its gradients
    (``grads``) and loss come out too."""
    from repro.optim import AdamWConfig, adamw
    from repro.training import steps as r_steps

    cfg = r_get_arch(arch).smoke().replace(**overrides)
    model = r_get_model(cfg)
    opt = AdamWConfig(**TRAIN_OPT)
    loss_fn = r_steps.build_loss_fn(model)
    step = r_steps.build_train_step(model, opt, microbatch)

    def run(key, batch):
        state = r_steps.init_train_state(model, key, opt)
        out = {"state0": state}
        if microbatch > 1:
            out["state1"], out["metrics"] = step(state, batch)
            return out
        loss, grads = jax.value_and_grad(loss_fn)(state["params"], batch)
        params, opt_state, metrics = adamw.update(
            grads, state["opt"], state["params"], opt)
        out.update(loss=loss, grads=grads, metrics=dict(metrics, loss=loss),
                   state1={"params": params, "opt": opt_state})
        return out

    batch = train_batch(cfg)
    out = jax.tree.map(np.asarray, jax.jit(run)(KEY, batch))
    out["batch"] = batch
    return out
