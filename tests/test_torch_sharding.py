"""The port's logical-axis sharding (``repro_torch.distributed``) held
against the reference's (``repro.distributed``): the spec tests of
``tests/test_distributed.py`` as twins, and the spec trees of every arch's
parameters, decode cache and train state on duck-typed meshes of 2x4,
16x16 and 2x16x16, key for key and leaf for leaf.

The trees resolve the port's logical axes against the reference's shapes
(``jax.eval_shape`` of the full-size models, which the CPU could not
hold); the port's own cache shapes (``cache_specs``, on the ``meta``
device) are checked equal to the reference's.  The placements of a
``DeviceMesh`` and the mesh helpers run on a one-rank gloo group.
"""

import functools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as RP

from repro.configs import get_arch as r_get_arch
from repro.distributed import sharding as RS
from repro.models import get_model as r_get_model
from repro.optim import AdamWConfig as RAdamWConfig
from repro.training import steps as r_steps
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.distributed import sharding as S
from repro_torch.models import get_model
from repro_torch.training import steps as tsteps


class FakeMesh:
    """Duck-typed mesh with a .shape mapping (enough for spec resolution)."""

    def __init__(self, shape):
        self.shape = shape


M2 = FakeMesh({"data": 16, "model": 16})
M3 = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"2x4": FakeMesh({"data": 2, "model": 4}), "16x16": M2,
          "2x16x16": M3}


def _both(logical, shape, mesh, want):
    port = S.logical_to_spec(logical, shape, mesh)
    ref = RS.logical_to_spec(logical, shape, mesh)
    assert tuple(port) == tuple(ref) == want, (port, ref, want)
    return port


# ----------------------------------------------- twins of the spec tests
def test_weight_2d_sharding():
    _both(("embed", "heads"), (2048, 4096), M2, ("data", "model"))


def test_non_divisible_replicates():
    _both(("layer", "batch", "cache_seq", "kv_heads", None),
          (36, 128, 32768, 2, 128), M2,
          (None, "data", "model", None, None))


def test_kv_heads_win_over_cache_seq_when_divisible():
    _both(("layer", "batch", "cache_seq", "kv_heads", None),
          (32, 128, 32768, 32, 128), M2,
          (None, "data", None, "model", None))


def test_batch_spans_pod_and_data():
    _both(("batch", None), (256, 7), M3, (("pod", "data"), None))


def test_batch_1_replicated():
    _both(("batch", None, None), (1, 5, 5), M3, (None, None, None))


def test_no_double_assignment_of_axis():
    spec = _both(("vocab", "ffn"), (160, 160), M2, ("model", None))
    assert spec.count("model") <= 1


def test_rules_and_batch_spec_are_the_reference_s():
    assert S.DEFAULT_RULES == RS.DEFAULT_RULES
    assert S.SERVE_RULES == RS.SERVE_RULES
    for mesh in MESHES.values():
        for ndim in (1, 2, 3):
            assert tuple(S.batch_spec(mesh, ndim)) == \
                tuple(RS.batch_spec(mesh, ndim))
    assert repr(S.P("data", None)) == "PartitionSpec('data', None)"


# ------------------------------------------------------- the spec trees
def _plain(tree):
    """A tree of specs as nested dicts of plain tuples."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tuple(tree)


def _shapes(tree):
    return jax.tree.map(lambda s: tuple(s.shape), tree)


def _ref_tree(tree):
    return _plain(jax.tree.map(tuple, tree,
                               is_leaf=lambda x: isinstance(x, RP)))


def _cfgs():
    out = {a: get_arch(a) for a in ARCH_IDS}
    # the pure Mamba2 model (family ssm with an SSD state)
    out["mamba2"] = get_arch("zamba2-1.2b").replace(shared_attn_every=0,
                                                    family="ssm")
    return out


CFGS = _cfgs()


def _ref_cfg(name):
    if name == "mamba2":
        return r_get_arch("zamba2-1.2b").replace(shared_attn_every=0,
                                                 family="ssm")
    return r_get_arch(name)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference model's axes and abstract shapes (full size)."""
    model = r_get_model(_ref_cfg(name))
    state = jax.eval_shape(lambda: r_steps.init_train_state(
        model, jax.random.PRNGKey(0), RAdamWConfig()))
    cache = model.cache_specs(4, 64)
    return {"params": (model.param_logical_axes(), state["params"]),
            "cache": (model.cache_logical_axes(), cache),
            "state": (r_steps.train_state_logical_axes(model, True), state)}


def _port_axes(name):
    model = get_model(CFGS[name], device="cpu")
    return model, {"params": model.param_logical_axes(),
                   "cache": model.cache_logical_axes(),
                   "state": tsteps.train_state_logical_axes(model, True)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(CFGS))
def test_spec_trees_equal_the_reference(name, mesh):
    ref = _reference(name)
    model, axes = _port_axes(name)
    for what in ("params", "cache", "state"):
        r_axes, r_shapes = ref[what]
        assert axes[what] == jax.tree.map(
            tuple, r_axes, is_leaf=lambda x: isinstance(x, tuple)), what
        want = _ref_tree(RS.tree_specs(r_axes, r_shapes, MESHES[mesh]))
        got = _plain(S.tree_specs(axes[what], _shapes(r_shapes),
                                  MESHES[mesh]))
        assert got == want, what
    # the port's own cache shapes and dtypes are the reference's
    port_cache = model.cache_specs(4, 64)
    r_cache = ref["cache"][1]
    assert {k: tuple(v.shape) for k, v in port_cache.items()} == \
        {k: tuple(v.shape) for k, v in r_cache.items()}
    assert all(v.device.type == "meta" for v in port_cache.values())
    assert {k: str(v.dtype)[6:] for k, v in port_cache.items()} == \
        {k: str(v.dtype) for k, v in r_cache.items()}


@pytest.mark.parametrize("name", ["llama3.2-3b", "deepseek-moe-16b",
                                  "rwkv6-1.6b", "zamba2-1.2b"])
def test_named_axes_are_the_stacked_axes_per_layer(name):
    """By parameter name, each layer's axes are the stacked tree's without
    its leading "layer" axis, for every parameter the model has."""
    cfg = get_arch(name).smoke()
    model = get_model(cfg, device="cpu").init(torch.Generator())
    named = model.named_logical_axes()
    assert list(named) == [n for n, _ in model.named_parameters()]
    stacked = model.param_logical_axes()
    for n, ax in named.items():
        parts = n.split(".")
        if parts[0] in model.STACKS:
            node = stacked[parts[0]]
            for k in parts[2:]:
                node = node[k]
            assert node == ("layer",) + ax, n
        else:
            assert stacked[parts[1]] == ax, n
        p = dict(model.named_parameters())[n]
        assert len(ax) == p.dim(), n
    state = tsteps.train_state(model)
    by_name = tsteps.train_state_logical_axes(model, True, by_name=True)
    assert set(by_name["opt"]) == set(state["opt"]) == {"m", "v", "count",
                                                        "master"}
    assert by_name["opt"]["m"] == named and by_name["opt"]["count"] == ()


# ------------------------------------------- DeviceMesh placements (1 rank)
@pytest.fixture
def one_rank():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


class FakeDeviceMesh:
    """What ``placements`` reads of a DeviceMesh: its names and rank."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names, self.ndim = shape, names, len(shape)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    mesh = FakeDeviceMesh((2, 16, 16), ("pod", "data", "model"))
    assert S.mesh_shape(mesh) == {"pod": 2, "data": 16, "model": 16}
    spec = S.logical_to_spec(("batch", "embed_act", "heads"), (64, 8, 32),
                             mesh)
    assert tuple(spec) == (("pod", "data"), None, "model")
    assert S.placements(spec, mesh) == (Shard(0), Shard(0), Shard(2))
    assert S.placements(S.P(None, "data"), mesh) == \
        (Replicate(), Shard(1), Replicate())
    axes = {"a": ("embed", "ffn"), "b": {"c": ("batch",)}}
    shapes = {"a": (32, 64), "b": {"c": torch.empty(6, device="meta")}}
    assert S.tree_shardings(axes, shapes, mesh) == {
        "a": (Replicate(), Shard(0), Shard(1)),
        "b": {"c": (Replicate(), Replicate(), Replicate())}}
    with pytest.raises(ValueError, match="tree keys differ"):
        S.tree_specs(axes, {"a": (32, 64)}, mesh)


def test_gather_constrain_and_mesh_helpers_on_one_rank(one_rank):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch import mesh as LM

    mesh = LM.make_debug_mesh((1, 1))
    assert mesh.mesh_dim_names == ("data", "model")
    assert S.mesh_shape(mesh) == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match=r"needs 256 ranks; the world has 1"):
        LM.make_production_mesh()
    with pytest.raises(ValueError, match=r"needs 512 ranks; the world has 1"):
        LM.make_production_mesh(multi_pod=True)
    assert LM.PRODUCTION_MESH[True] == \
        ((2, 16, 16), ("pod", "data", "model"))
    w = S.distribute(torch.arange(12.).reshape(3, 4), mesh,
                     S.placements(S.P("data", "model"), mesh))
    g = S.make_weight_gather(mesh)({"w": w}, {"w": ("embed", "ffn")})["w"]
    assert g.placements == (Replicate(), Shard(1))     # model axis only
    assert torch.equal(g.full_tensor(), torch.arange(12.).reshape(3, 4))
    x = S.constrain(w, ("batch", None), mesh)
    assert x.placements == (Shard(0), Replicate())
    plain = torch.ones(2)
    assert S.make_weight_gather(mesh)({"p": plain}, {"p": ("embed",)})[
        "p"] is plain


def test_init_distributed_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.launch.mesh import init_distributed
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed("cuda")
    assert not dist.is_initialized()


def test_sharded_model_places_weights_by_rule(one_rank):
    """``ZooModel.shard`` and ``shard_train_state`` on a one-rank mesh:
    every leaf is a DTensor placed as ``tree_shardings`` says, the values
    are the plain model's, and the model still computes the same logits."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import AdamWConfig

    mesh = make_mesh((1, 1), ("data", "model"))
    cfg = get_arch("llama3.2-3b").smoke()
    plain = get_model(cfg, device="cpu").init(torch.Generator())
    model = get_model(cfg, device="cpu").init(torch.Generator())
    state = tsteps.shard_train_state(model, mesh, AdamWConfig())
    axes = tsteps.train_state_logical_axes(model, True, by_name=True)
    want = S.tree_shardings(axes, state, mesh)
    for k, p in state["params"].items():
        assert isinstance(p, DTensor) and tuple(p.placements) == \
            want["params"][k]
        assert p is dict(model.named_parameters())[k]
        assert torch.equal(p.full_tensor(), dict(plain.named_parameters())[k])
    assert isinstance(state["opt"]["count"], DTensor)
    assert model.mesh is mesh
    tokens = torch.arange(16).reshape(2, 8) % cfg.vocab_size
    with torch.no_grad():
        np.testing.assert_allclose(
            model.forward(tokens).full_tensor().numpy(),
            plain.forward(tokens).numpy(), rtol=1e-5, atol=1e-5)
