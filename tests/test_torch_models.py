"""The port's transformer models against the reference.

Inputs are numpy arrays from a seed; the reference's weights reach the port
through ``repro_torch.models.convert``, so both packages compute with the
same values.  Whole models (two layers and a head, in float32) are held
within 1e-4, the loss within 1e-5.  The reference side is jitted and
computed once per arch.  The layers are in ``test_torch_layers.py``, the
serving twins (prefill, decode, ``launch.serve``) in
``test_torch_serve.py``.
"""

import jax
import numpy as np
import pytest
import torch

from repro.training import steps as r_steps
from repro_torch.configs import get_arch
from repro_torch.models import NOT_PORTED, TransformerModel, get_model
from repro_torch.training import steps as t_steps

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from _torch_zoo import (B, CPU, S, TRANSFORMER_ARCHS, close, n, port_model,
                        reference, t)


# ------------------------------------------------------------------ models
@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_forward_matches_reference(arch):
    ref = reference(arch)
    logits = port_model(arch, ref).forward(t(ref["inputs"]))
    assert logits.shape == ref["forward"].shape
    close(logits, ref["forward"], 1e-4)


def test_port_init_is_the_reference_distribution():
    """The port draws its own weights (a torch generator, not JAX's keys):
    same shapes, dtypes and fan-in scale, cut at two standard deviations."""
    cfg = get_arch("deepseek-moe-16b").smoke()
    model = TransformerModel(cfg, device=CPU).init(
        torch.Generator().manual_seed(0))
    ref = reference("deepseek-moe-16b")["params"]
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        flat[".".join(str(p.key) for p in path)] = leaf
    seen = set()
    for name, p in model.named_parameters():
        if name.startswith("layers."):
            i, rest = name.split(".", 2)[1:]
            key, r = "layers." + rest, flat["layers." + rest][int(i)]
        else:
            key = name.split(".", 1)[1]
            r = flat[key]
        seen.add(key)
        assert tuple(p.shape) == r.shape and n(p).dtype == r.dtype, name
        if "norm" in name or name.split(".")[-1].startswith("b"):
            continue
        fan_in = p.shape[-1] if name.endswith("embed") else p.shape[-2]
        std = 1.0 / np.sqrt(fan_in)
        assert float(p.abs().max()) <= 2 * std * (1 + 1e-6), name
        assert 0.7 * std < float(p.std()) < 1.0 * std, name
    assert seen == set(flat)


def test_ssm_families_are_not_ported():
    for arch in ("rwkv6-1.6b", "zamba2-1.2b"):
        with pytest.raises(NotImplementedError, match="item 12b"):
            get_model(get_arch(arch).smoke(), device=CPU)
    assert set(NOT_PORTED) == {"ssm", "hybrid"}


def test_model_without_a_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
        TransformerModel(get_arch("llama3.2-3b").smoke())
    with pytest.raises(RuntimeError, match="no weights"):
        TransformerModel(get_arch("llama3.2-3b").smoke(),
                         device=CPU).forward(torch.zeros((1, 4), dtype=int))


# ------------------------------------------------------------------- steps
def test_cross_entropy_and_forward_step_match():
    ref = reference("qwen2.5-3b")
    labels = np.random.default_rng(12).integers(0, 256, (B, S)).astype(
        np.int32)
    expect = r_steps.cross_entropy(ref["forward"], labels)
    close(t_steps.cross_entropy(t(ref["forward"]), t(labels)), expect, 1e-5)
    got = t_steps.build_forward_step(port_model("qwen2.5-3b", ref))(
        {"inputs": t(ref["inputs"]), "labels": t(labels)})
    close(got, expect, 1e-5)
