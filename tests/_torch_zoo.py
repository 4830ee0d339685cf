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
from repro_torch.models import TransformerModel
from repro_torch.models.convert import load_reference_params

CPU = "cpu"
KEY = jax.random.PRNGKey(0)
TRANSFORMER_ARCHS = ["qwen2.5-3b", "codeqwen1.5-7b", "stablelm-1.6b",
                     "llama3.2-3b", "internvl2-26b", "hubert-xlarge",
                     "qwen3-moe-235b-a22b", "deepseek-moe-16b"]
CAUSAL_ARCHS = [a for a in TRANSFORMER_ARCHS if get_arch(a).causal]
B, S, STEPS = 2, 16, 3


def t(x, dtype=None):
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def n(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def close(a, b, tol):
    np.testing.assert_allclose(n(a), n(b), rtol=tol, atol=tol)


def inputs(cfg, seed=0, Bq=B, Sq=S):
    """Prompt tokens, or frontend embeddings for a stub-frontend arch."""
    rng = np.random.default_rng(seed)
    if cfg.embedding_input:
        return rng.standard_normal((Bq, Sq, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (Bq, Sq)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def reference(arch, decode: bool = False):
    """The reference's smoke model on seed-0 weights, in one jitted call:
    params and the forward logits (numpy); with ``decode``, the prefill
    (room for STEPS + 1 more tokens) and STEPS greedy decode steps, each
    (logits, cache), and the tokens fed to them."""
    cfg = r_get_arch(arch).smoke()
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


def port_model(arch, ref):
    """The port's smoke model of ``arch`` on the reference's weights."""
    return load_reference_params(
        TransformerModel(get_arch(arch).smoke(), device=CPU), ref["params"])
