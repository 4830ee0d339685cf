"""Ranks of a gloo process group on the CPU, for the port's distributed
tests: :func:`run_ranks` spawns ``world`` processes, each joins the group
(``launch.mesh.init_distributed`` from torchrun-style variables on a free
localhost port) and runs one of the rank bodies below; their return values
come back in rank order.  The bodies import only torch and ``repro_torch``
(a spawned process imports this module, not the test's)."""

import os
import pickle
import socket
import tempfile
import traceback

import torch
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, fn, args, out_dir):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_distributed, shutdown
    try:
        init_distributed("cpu")
        res = ("ok", fn(rank, world, *args))
    except BaseException:                                   # noqa: BLE001
        res = ("err", traceback.format_exc())
    finally:
        shutdown()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def run_ranks(fn, world: int, *args, timeout: float = 300.0) -> list:
    """``fn(rank, world, *args)`` on ``world`` gloo ranks; their results in
    rank order.  A rank's exception fails the caller with its traceback."""
    ctx = mp.get_context("spawn")
    port = _free_port()
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_entry,
                             args=(r, world, port, fn, args, d))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        out = []
        for r in range(world):
            path = os.path.join(d, f"{r}.pkl")
            if not os.path.exists(path):
                raise AssertionError(f"rank {r} of {world} left no result "
                                     f"(exit code {procs[r].exitcode})")
            with open(path, "rb") as f:
                status, val = pickle.load(f)
            if status != "ok":
                raise AssertionError(f"rank {r} of {world} failed:\n{val}")
            out.append(val)
    return out


# ------------------------------------------------------------- rank bodies
def ring_rank(rank, world, cases):
    """The MESH tier's ring and ``direct_mesh_ooc_gemm`` on a 1-D "model"
    mesh of the world, for each case ``(A, B, C, alpha, beta, dtype)``:
    the gathered C for overlap on and off and the direct ring, each rank's
    sent bytes, and kernel launches (the plain version counts none)."""
    from repro_torch.core import Device, MeshOocRuntime, ooc_gemm
    from repro_torch.direct_impls import direct_mesh_ooc_gemm
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((world,), ("model",))
    out = []
    for A, B, C, alpha, beta, dtype in cases:
        dt = getattr(torch, dtype)
        a, b, c = (torch.from_numpy(x).to(dt) for x in (A, B, C))
        rt = MeshOocRuntime(mesh, device=Device("MESH", 0, 1 << 20))
        res = {}
        for overlap in (True, False):
            C_out = rt.gemm(a, b, c, alpha, beta, overlap=overlap)
            res[overlap] = C_out.full_tensor()
            res[f"bytes{overlap}"] = rt.last_p2p_bytes
            res[f"local{overlap}"] = tuple(C_out.to_local().shape)
        res["direct"] = direct_mesh_ooc_gemm(a, b, c, alpha, beta,
                                             mesh).full_tensor()
        res["api"] = ooc_gemm(a, b, c, alpha, beta, budget_bytes=1 << 20,
                              backend="mesh", mesh=mesh).full_tensor()
        out.append({k: v.float().numpy() if torch.is_tensor(v) else v
                    for k, v in res.items()})
    return out


def compress_rank(rank, world, grads, errors):
    """``compressed_pod_psum`` over a 1-D "pod" mesh: this rank's
    gradients are ``grads[rank]``; returns (mean, error, payloads)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import compression

    mesh = make_mesh((world,), ("pod",))
    g = {k: torch.from_numpy(v) for k, v in grads[rank].items()}
    e = {k: torch.from_numpy(v) for k, v in errors[rank].items()}
    stats = {}
    mean, err = compression.compressed_pod_psum(g, e, mesh, stats=stats)
    return ({k: v.numpy() for k, v in mean.items()},
            {k: v.numpy() for k, v in err.items()},
            {k: v.numpy() for k, v in stats["q"].items()})


SMOKE_B, SMOKE_S = 8, 32


def _smoke(arch):
    from repro_torch.configs import get_arch
    return get_arch(arch).smoke().replace(num_heads=4, num_kv_heads=4)


def _batch(cfg):
    g = torch.Generator().manual_seed(1)
    shape = (SMOKE_B, SMOKE_S)
    return {"inputs": torch.randint(0, cfg.vocab_size, shape, generator=g),
            "labels": torch.randint(0, cfg.vocab_size, shape, generator=g)}


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def sharded_steps_rank(rank, world, archs, mesh_shape, device="cpu"):
    """For each arch's smoke config (4 heads, 4 KV heads): one train step
    and one decode step on a (data, model) mesh with ``weight_gather``,
    beside the port's unsharded steps from the same weights, on
    ``device``.  Returns, per arch, the largest differences of the loss,
    the updated parameters and optimizer state, the decode logits and the
    decode cache."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed import (batch_spec, distribute,
                                         logical_to_spec, make_weight_gather,
                                         placements)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import steps as tsteps

    mesh = make_mesh(mesh_shape, ("data", "model"))
    gather = make_weight_gather(mesh)
    opt = AdamWConfig()
    seed = lambda: torch.Generator(device).manual_seed(0)    # noqa: E731
    out = {}
    for arch in archs:
        cfg = _smoke(arch)
        batch = {k: v.to(device) for k, v in _batch(cfg).items()}
        plain = get_model(cfg, device=device)
        st0 = tsteps.init_train_state(plain, seed(), opt)
        st0, m0 = tsteps.build_train_step(plain, opt)(st0, batch)

        model = get_model(cfg, device=device, weight_gather=gather)
        model.init(seed())
        st1 = tsteps.shard_train_state(model, mesh, opt)
        bp = placements(batch_spec(mesh, 2), mesh)
        db = {k: distribute_tensor(v, mesh, bp, src_data_rank=None)
              for k, v in batch.items()}
        st1, m1 = tsteps.build_train_step(model, opt)(st1, db)
        perr = max(float((_full(st1["params"][k]).float()
                          - st0["params"][k].float()).abs().max())
                   for k in st0["params"])
        oerr = max(float((_full(st1["opt"][t][k]) - st0["opt"][t][k])
                         .abs().max())
                   for t in ("m", "v", "master") for k in st0["opt"][t])
        res = {"loss": (float(m0["loss"]), float(_full(m1["loss"]))),
               "param_err": perr, "opt_err": oerr,
               "placed": {k: str(p.placements)
                          for k, p in st1["params"].items()}}

        with torch.no_grad():
            ref = get_model(cfg, device=device).init(seed())
            _, cache = ref.prefill(batch["inputs"][:, :16], max_len=24)
            axes = ref.cache_logical_axes()
            dcache = {k: distribute(v.clone(), mesh, placements(
                logical_to_spec(axes[k], v.shape, mesh), mesh))
                for k, v in cache.items()}
            tok = batch["inputs"][:, 16]
            lg0, c0 = ref.decode(cache, tok)
            dec = get_model(cfg, device=device, weight_gather=gather)
            dec.init(seed()).shard(mesh)
            lg1, c1 = dec.decode(dcache, distribute_tensor(
                tok, mesh, placements(batch_spec(mesh, 1), mesh),
                src_data_rank=None))
            res["decode_err"] = float((_full(lg1) - lg0).abs().max())
            res["cache_err"] = max(
                float((_full(c1[k]).float() - c0[k].float()).abs().max())
                for k in c0)
        out[arch] = res
    return out


def seq_decode_rank(rank, world, cases, mesh_shape, max_len):
    """Decode on a sequence-sharded cache: for each ``(arch, params,
    prompt, tokens)`` (the smoke config, whose 2 KV heads do not divide a
    model axis of 4, so the rules shard the caches' ``cache_seq`` over it),
    the model on ``params`` (the reference's tree) is sharded on a (data,
    model) mesh, ``build_prefill_step`` with ``cache_shardings`` fills
    and places the cache, and one decode step runs per token.  Returns,
    per arch, the caches' placements, the prefill's logits and cache and
    each step's logits and cache, gathered, and the sequence-parallel
    kernel-2 passes' counts (0 on the CPU: the plain versions run)."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import (batch_spec, distribute,
                                         make_weight_gather, placements,
                                         tree_shardings)
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_model
    from repro_torch.models.convert import load_reference_params
    from repro_torch.training import steps as tsteps

    mesh = make_mesh(mesh_shape, ("data", "model"))
    full = lambda c: {k: _full(v).numpy() for k, v in c.items()}  # noqa
    out = {}
    for arch, params, prompt, tokens in cases:
        cfg = get_arch(arch).smoke()
        model = get_model(cfg, device="cpu",
                          weight_gather=make_weight_gather(mesh))
        load_reference_params(model, params).shard(mesh)
        specs = model.cache_specs(prompt.shape[0], max_len)
        shardings = tree_shardings(model.cache_logical_axes(), specs, mesh)
        put = lambda x: distribute(torch.from_numpy(x), mesh,  # noqa: E731
                                   placements(batch_spec(mesh, x.ndim), mesh))
        with torch.no_grad():
            logits, cache = tsteps.build_prefill_step(
                model, max_len, cache_shardings=shardings)(put(prompt))
            res = {"placed": {k: str(v.placements) for k, v in cache.items()},
                   "steps": [(_full(logits).numpy(), full(cache))]}
            step = tsteps.build_decode_step(model)
            for tok in tokens:
                logits, cache = step(cache, put(tok))
                res["steps"].append((_full(logits).numpy(), full(cache)))
        res["launches"] = {
            p.__name__: p.launches_by_path.get("seq_decode", 0)
            for p in (kfa.flash_partial, kfa.flash_combine)}
        out[arch] = res
    return out


def elastic_rank(rank, world, shape, mode, ckpt):
    """The reference's elastic script (``tests/test_elastic.py``) in the
    port: stablelm smoke (4 heads, 4 KV heads) on a ``shape`` (data,
    model) mesh.  ``save``: the sharded state after one step on zeros is
    checkpointed; ``restore``: the checkpoint is placed onto this mesh
    (``restore(shardings=, mesh=)``).  Returns the parameters' checksum
    and the sharded model's loss on a fixed batch, and where a restored
    leaf lives."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import batch_spec, placements, tree_shardings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import steps as tsteps

    rows, cols = (int(x) for x in shape.split("x"))
    mesh = make_mesh((rows, cols), ("data", "model"))
    cfg = _smoke("stablelm-1.6b")
    opt = AdamWConfig()
    model = get_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    state = tsteps.shard_train_state(model, mesh, opt)
    mgr = CheckpointManager(ckpt)
    bp = placements(batch_spec(mesh, 2), mesh)
    put = lambda b: {k: distribute_tensor(v, mesh, bp,     # noqa: E731
                                          src_data_rank=None)
                     for k, v in b.items()}
    batch = {"inputs": torch.arange(8 * 16, dtype=torch.int32).reshape(
        8, 16) % 64, "labels": torch.ones((8, 16), dtype=torch.int32)}
    placed = None
    if mode == "save":
        zeros = {"inputs": torch.zeros((8, 16), dtype=torch.int32),
                 "labels": torch.zeros((8, 16), dtype=torch.int32)}
        state, _ = tsteps.build_train_step(model, opt)(state, put(zeros))
        mgr.save(1, state, data_cursor=1, blocking=True)
    else:
        axes = tsteps.train_state_logical_axes(model, True, by_name=True)
        restored, cursor = mgr.restore(
            1, state, shardings=tree_shardings(axes, state, mesh),
            mesh=mesh)
        assert cursor == 1
        with torch.no_grad():
            for k, p in state["params"].items():
                p.to_local().copy_(restored["params"][k].to_local())
        lead = restored["params"][next(iter(restored["params"]))]
        placed = (tuple(lead.device_mesh.shape),
                  str(lead.placements))
    ck = float(sum(_full(p).float().abs().sum()
                   for p in state["params"].values()))
    with torch.no_grad():
        loss = float(_full(tsteps.build_loss_fn(model)(put(batch))))
    return {"checksum": ck, "loss": loss, "placed": placed}


def train_main_rank(rank, world, argv):
    """``launch.train.main`` with ``--mesh on`` on this world; returns the
    losses and the mesh's shape."""
    from repro_torch.launch import train

    res = train.main(list(argv) + ["--mesh", "on"])
    return {"losses": res["losses"],
            "mesh": tuple(res["mesh"].shape),
            "names": tuple(res["mesh"].mesh_dim_names),
            "gather": res["model"].weight_gather is not None}


def in_turn(rank, world, *calls):
    """Several rank bodies in one spawn of the world (``calls`` are
    ``(body, args)`` pairs); their results as a tuple."""
    return tuple(body(rank, world, *args) for body, args in calls)


def elastic_runner(ckpt: str):
    """``run(ranks, "RxC", "save" | "restore")``: :func:`elastic_rank` on
    that many ranks, every rank's checksum and loss equal (and, on a
    restore, the restored leaves on a mesh of that shape); rank 0's
    result."""
    def run(ndev, shape, mode):
        out = run_ranks(elastic_rank, ndev, shape, mode, ckpt, timeout=600)
        rows, cols = (int(x) for x in shape.split("x"))
        for r in out:
            assert r == {**out[0], "placed": r["placed"]}
            if mode == "restore":
                assert r["placed"][0] == (rows, cols)
        return out[0]
    return run


def assert_parity(saved, restored, what):
    """The reference's elastic parity bounds: checksum 1e-5, loss 1e-4
    (relative)."""
    assert abs(saved["checksum"] - restored["checksum"]) \
        <= 1e-5 * abs(saved["checksum"]), what
    assert abs(saved["loss"] - restored["loss"]) \
        <= 1e-4 * max(abs(saved["loss"]), 1e-8), what
