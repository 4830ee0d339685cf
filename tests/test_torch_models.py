"""The port's models against the reference.

Inputs are numpy arrays from a seed; the reference's weights reach the port
through ``repro_torch.models.convert``, so both packages compute with the
same values.  Whole models (two layers and a head, in float32) are held
within 1e-4, the loss within 1e-5.  The reference side is jitted and
computed once per arch.  The layers are in ``test_torch_layers.py``, the
serving twins (prefill, decode, ``launch.serve``) in
``test_torch_serve.py``.
"""

import numpy as np
import pytest
import torch

from repro.configs import get_arch as r_get_arch
from repro.models import get_model as r_get_model
from repro.training import steps as r_steps
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.models import NOT_PORTED, TransformerModel, get_model
from repro_torch.training import steps as t_steps

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from _torch_zoo import (ARCHS, B, CPU, S, check_port_init, close, port_model,
                        reference, t)


# ------------------------------------------------------------------ models
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    ref = reference(arch)
    logits = port_model(arch, ref).forward(t(ref["inputs"]))
    assert logits.shape == ref["forward"].shape
    close(logits, ref["forward"], 1e-4)


def test_port_init_is_the_reference_distribution():
    """The port draws its own weights (a torch generator, not JAX's keys):
    same shapes, dtypes and fan-in scale, cut at two standard deviations;
    constants equal to the reference's."""
    cfg = get_arch("deepseek-moe-16b").smoke()
    model = TransformerModel(cfg, device=CPU).init(
        torch.Generator().manual_seed(0))
    check_port_init(model, reference("deepseek-moe-16b")["params"])


def test_every_family_is_ported():
    """Nothing is left out of ``get_model``: each arch (and the pure-Mamba2
    variant, the family ``ssm`` with a state) gets the class of the
    reference's own ``get_model``."""
    assert NOT_PORTED == {}
    cfgs = [get_arch(a).smoke() for a in ARCH_IDS] + [
        get_arch("zamba2-1.2b").smoke().replace(shared_attn_every=0,
                                                family="ssm")]
    for cfg in cfgs:
        rcfg = r_get_arch(cfg.name).smoke().replace(
            family=cfg.family, shared_attn_every=cfg.shared_attn_every)
        ours = get_model(cfg, device=CPU)
        assert type(ours).__name__ == type(r_get_model(rcfg)).__name__
        assert ours.device == torch.device(CPU)


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
