"""The port's serving path (prefill, decode, ``launch.serve``) against the
reference, for the transformers and the state-space families.

Prompts are numpy arrays from a seed; the reference's weights reach the
port through ``repro_torch.models.convert``.  On the CPU each decode step's
attention runs kernel 2's plain version.  Tolerances: 1e-4 for whole models
in float32 (as ``test_torch_models.py``), the reference test's 2e-3 for
decode against forward, and greedy tokens equal.  The reference side is
jitted and computed once per arch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as r_get_arch
from repro.models import get_model as r_get_model
from repro_torch.configs import get_arch
from repro_torch.examples import serve_decode
from repro_torch.launch import serve
from repro_torch.models import TransformerModel, get_model
from repro_torch.training import steps as t_steps

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from _torch_zoo import (B, CAUSAL_ARCHS, CPU, S, STEPS, close, close_cache,
                        inputs, port_model, reference, t)


@pytest.mark.parametrize("arch", CAUSAL_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill logits and cache, then STEPS decode steps on the reference's
    tokens, each within 1e-4."""
    ref = reference(arch, decode=True)
    model = port_model(arch, ref)
    logits, cache = model.prefill(t(ref["inputs"]), max_len=S + STEPS + 1)
    close(logits, ref["steps"][0][0], 1e-4)
    close_cache(cache, ref["steps"][0][1], 1e-4)
    for tok, (r_logits, r_cache) in zip(ref["tokens"], ref["steps"][1:]):
        logits, cache = model.decode(cache, t(tok))
        close(logits, r_logits, 1e-4)
        close_cache(cache, r_cache, 1e-4)


@pytest.mark.parametrize("arch", CAUSAL_ARCHS)
def test_generate_gives_the_reference_tokens(arch):
    """``generate`` on the reference's weights and prompts: the reference's
    greedy tokens, final logits and cache."""
    ref = reference(arch, decode=True)
    res = serve.generate(port_model(arch, ref), t(ref["inputs"]), STEPS + 1)
    last_logits, last_cache = ref["steps"][-1]
    expect = np.stack(ref["tokens"] + [last_logits.argmax(-1)], axis=1)
    np.testing.assert_array_equal(res["tokens"].numpy(), expect)
    close(res["logits"], last_logits, 1e-4)
    close_cache(res["cache"], last_cache, 1e-4)
    assert res["prefill_s"] > 0 and res["decode_s"] > 0
    assert "decode_mallocs" not in res          # measured on a card only


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-moe-16b"])
def test_generate_long_greedy_run_matches_reference_loop(arch):
    """Twelve tokens from the reference's own loop (its jitted prefill and
    decode steps, as ``repro.launch.serve`` runs them) and from
    ``generate``."""
    gen = 12
    cfg = r_get_arch(arch).smoke()
    model = r_get_model(cfg)
    ref = reference(arch, decode=True)
    params = ref["params"]
    prompts = inputs(cfg, seed=3, Bq=3, Sq=10)
    prefill = jax.jit(lambda p, x: model.prefill(p, x, max_len=10 + gen))
    decode = jax.jit(model.decode)
    logits, cache = prefill(params, prompts)
    toks = [jnp.argmax(logits, axis=-1)]
    for _ in range(gen - 1):
        logits, cache = decode(params, cache, toks[-1])
        toks.append(jnp.argmax(logits, axis=-1))
    res = serve.generate(port_model(arch, ref), t(prompts), gen)
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  np.stack([np.asarray(x) for x in toks], 1))
    assert int(res["cache"]["len"][0]) == 10 + gen - 1


@pytest.mark.parametrize("arch", CAUSAL_ARCHS)
def test_arch_smoke_decode(arch):
    """Twin of ``test_models.py::test_arch_smoke_decode`` on the port's own
    init: prefill + 3 decode steps, shapes, finiteness, cache length; the
    cache has the reference's ``cache_specs`` (names, shapes, dtypes)."""
    cfg = get_arch(arch).smoke()
    model = get_model(cfg, device=CPU).init(torch.Generator().manual_seed(0))
    logits, cache = model.prefill(t(inputs(cfg, seed=1)), max_len=S + 4)
    assert logits.shape == (B, cfg.vocab_size)
    specs = r_get_model(r_get_arch(arch).smoke()).cache_specs(B, S + 4)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[1])
            for k, v in cache.items()} == {
        k: (tuple(v.shape), v.dtype.name) for k, v in specs.items()}
    for _ in range(3):
        logits, cache = model.decode(cache, logits.argmax(-1))
        assert bool(torch.isfinite(logits).all())
    assert int(cache["len"][0]) == S + 3


@pytest.mark.parametrize("init", ["port", "reference"])
def test_decode_matches_forward_dense(init):
    """Twin of ``test_models.py::test_decode_matches_forward_dense``:
    teacher-forced decode reproduces forward's logits (2e-3), on the port's
    own weights and on the reference's."""
    cfg = get_arch("llama3.2-3b").smoke()
    if init == "port":
        model = TransformerModel(cfg, device=CPU).init(
            torch.Generator().manual_seed(0))
    else:
        model = port_model("llama3.2-3b",
                           reference("llama3.2-3b", decode=True))
    Sq = 12
    toks = t(inputs(cfg, seed=2, Sq=Sq))
    full = model.forward(toks)
    logits, cache = model.prefill(toks[:, :5], max_len=Sq)
    close(logits, full[:, 4], 2e-3)
    for i in range(5, Sq):
        logits, cache = model.decode(cache, toks[:, i])
        close(logits, full[:, i], 2e-3)


def test_serving_steps_wrap_the_model():
    ref = reference("llama3.2-3b", decode=True)
    model = port_model("llama3.2-3b", ref)
    logits, cache = t_steps.build_prefill_step(model, max_len=S + STEPS + 1)(
        t(ref["inputs"]))
    close(logits, ref["steps"][0][0], 1e-4)
    logits, cache = t_steps.build_decode_step(model)(cache,
                                                     t(ref["tokens"][0]))
    close(logits, ref["steps"][1][0], 1e-4)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b"])
def test_serving_steps_wrap_the_ssm_models(arch):
    """The serving steps take the state-space families unchanged."""
    ref = reference(arch, decode=True)
    model = port_model(arch, ref)
    logits, cache = t_steps.build_prefill_step(model, max_len=S + STEPS + 1)(
        t(ref["inputs"]))
    close(logits, ref["steps"][0][0], 1e-4)
    logits, cache = t_steps.build_decode_step(model)(cache,
                                                     t(ref["tokens"][0]))
    close(logits, ref["steps"][1][0], 1e-4)
    close_cache(cache, ref["steps"][1][1], 1e-4)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2.5-3b",
                                  "deepseek-moe-16b", "internvl2-26b",
                                  "rwkv6-1.6b", "zamba2-1.2b"])
def test_serve_main_smoke_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                      "--prompt-len", "12", "--gen", "5", "--device", CPU])
    assert out["tokens"].shape == (2, 5)
    assert int(out["cache"]["len"][0]) == 12 + 5 - 1
    assert out["tput"] > 0 and out["decode_mallocs"] is None
    text = capsys.readouterr().out
    assert "prefill" in text and "tok/s" in text


def test_serve_main_refuses_an_encoder():
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--smoke", "--device", CPU])


def test_serve_main_same_seed_same_tokens():
    argv = ["--arch", "qwen3-moe-235b-a22b", "--smoke", "--batch", "2",
            "--prompt-len", "8", "--gen", "4", "--device", CPU]
    a, b = serve.main(argv), serve.main(argv)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = serve.main(argv + ["--seed", "1"])
    assert not torch.equal(a["prompts"], c["prompts"])
    assert not torch.equal(a["model"].top["lm_head"],
                           c["model"].top["lm_head"])


def test_serve_decode_example_on_cpu(capsys):
    serve_decode.main(["--cpu", "--arch", "llama3.2-3b"])
    assert "serve_decode OK" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b"])
def test_serve_decode_example_serves_the_ssm_families(arch, capsys):
    serve_decode.main(["--cpu", "--arch", arch])
    assert "serve_decode OK" in capsys.readouterr().out
