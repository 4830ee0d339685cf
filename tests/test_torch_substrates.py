"""The port's data pipeline, checkpoints and training driver against the
reference: twins of ``tests/test_substrates.py``'s data and checkpoint
tests and of its restart test, with the port's batches held bitwise to the
reference's and five train steps to the reference driver's losses."""

import json
import os

import numpy as np
import pytest
import torch

from repro.data import MemmapSource as RMemmapSource
from repro.data import SyntheticSource as RSyntheticSource
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import MemmapSource, Prefetcher, SyntheticSource

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse)


def same_batch(a, b):
    assert set(a) == set(b) == {"inputs", "labels"}
    for k in a:
        assert a[k].dtype == b[k].dtype == np.int32
        np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------------------ data
def test_synthetic_deterministic_and_seekable():
    src = SyntheticSource(vocab_size=1000, seed=3)
    a = src.batch_at(7, 8, 16)
    same_batch(a, src.batch_at(7, 8, 16))
    same_batch(a, RSyntheticSource(vocab_size=1000, seed=3).batch_at(7, 8,
                                                                      16))
    c = src.batch_at(8, 8, 16)
    assert not np.array_equal(a["inputs"], c["inputs"])
    np.testing.assert_array_equal(a["labels"][:, :-1], a["inputs"][:, 1:])
    assert a["inputs"].max() < 1000


def test_synthetic_host_sharding_partitions_batch():
    src = SyntheticSource(vocab_size=500, seed=0)
    full = src.batch_at(3, 8, 4, host_index=0, host_count=1)
    h0 = src.batch_at(3, 8, 4, host_index=0, host_count=2)
    h1 = src.batch_at(3, 8, 4, host_index=1, host_count=2)
    np.testing.assert_array_equal(
        np.concatenate([h0["inputs"], h1["inputs"]]), full["inputs"])
    ref = RSyntheticSource(vocab_size=500, seed=0)
    same_batch(h1, ref.batch_at(3, 8, 4, host_index=1, host_count=2))


def test_memmap_source(tmp_path):
    path = str(tmp_path / "tokens.bin")
    rng = np.random.default_rng(4)
    rng.integers(0, 1 << 20, 10000).astype(np.int32).tofile(path)
    src, ref = MemmapSource(path, vocab_size=5000), RMemmapSource(path, 5000)
    for step in (0, 3, 97):
        b = src.batch_at(step, 4, 16)
        assert b["inputs"].shape == (4, 16)
        same_batch(b, ref.batch_at(step, 4, 16))
    np.arange(10000, dtype=np.int32).tofile(path)
    b = MemmapSource(path, vocab_size=1 << 30).batch_at(0, 4, 16)
    np.testing.assert_array_equal(b["labels"], b["inputs"] + 1)


def test_prefetcher_orders_steps():
    src = SyntheticSource(vocab_size=100, seed=1)
    ref = RSyntheticSource(vocab_size=100, seed=1)
    pf = Prefetcher(src, batch=4, seq=8, start_step=5, depth=2)
    try:
        for expect in (5, 6, 7):
            step, batch = next(pf)
            assert step == expect
            same_batch(batch, ref.batch_at(step, 4, 8))
    finally:
        pf.close()


# ------------------------------------------------------------- checkpoints
def test_checkpoint_roundtrip_and_gc(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"params": {"w": torch.from_numpy(
        rng.standard_normal((4, 4)).astype(np.float32))},
        "step": torch.tensor(3)}
    for step in (1, 2, 3):
        mgr.save(step, state, data_cursor=step * 10, blocking=True)
    assert mgr.all_steps() == [2, 3]  # keep=2 garbage-collects step 1
    target = {"params": {"w": torch.zeros(4, 4)},
              "step": torch.tensor(0)}
    restored, cursor = mgr.restore(3, target)
    assert cursor == 30
    assert restored["params"]["w"] is target["params"]["w"]
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    assert int(restored["step"]) == 3
    manifest = json.load(open(tmp_path / "step_000000003" / "manifest.json"))
    assert set(manifest) == {"step", "data_cursor", "leaves"}
    assert set(manifest["leaves"]) == {"params.w", "step"}
    assert manifest["leaves"]["params.w"]["dtype"] == "float32"


def test_checkpoint_atomic_no_partial(tmp_path):
    """tmp dirs never count as checkpoints."""
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(os.path.join(str(tmp_path), "tmp.99.0"))
    assert mgr.latest_step() is None
    mgr.save(5, {"w": torch.ones(2)}, blocking=True)
    assert mgr.latest_step() == 5


def test_checkpoint_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.ones(2), "w": torch.ones(2, 2)}, blocking=True)
    bad = {"a": torch.zeros(2), "w": torch.zeros(3, 3)}
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, bad)
    assert torch.equal(bad["a"], torch.zeros(2))   # nothing written


def test_checkpoint_bf16_roundtrip_without_ml_dtypes(tmp_path):
    """A bf16 leaf is stored as its uint16 bits (numpy has no bf16) and
    comes back bit for bit; the snapshot is taken at ``save``, so an
    in-place update right after it does not reach the async write."""
    w = torch.randn(5, 7).to(torch.bfloat16)
    keep = w.clone()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, {"w": w, "n": torch.tensor(7, dtype=torch.int32)})
    w.add_(1.0)
    mgr.wait()
    meta = json.load(open(tmp_path / "step_000000002" / "manifest.json"))
    leaf = meta["leaves"]["w"]
    assert leaf["dtype"] == "bfloat16" and leaf["shape"] == [5, 7]
    arr = np.load(tmp_path / "step_000000002" / leaf["file"])
    assert arr.dtype == np.uint16
    target = {"w": torch.zeros(5, 7, dtype=torch.bfloat16),
              "n": torch.tensor(0, dtype=torch.int32)}
    mgr.restore(2, target)
    assert torch.equal(target["w"].view(torch.int16),
                       keep.view(torch.int16))
    assert int(target["n"]) == 7


# ---------------------------------------------------------------- driver
SMOKE = ["--arch", "stablelm-1.6b", "--smoke", "--batch", "2", "--seq", "32",
         "--log-every", "100", "--device", "cpu"]


def test_train_restart_resumes_identically(tmp_path):
    """Twin of ``test_substrates.py::test_train_restart_resumes_
    identically`` through the port's ``launch.train.main``: 7 steps, a
    checkpoint, 7 resumed steps give the losses of 14 straight ones."""
    from repro_torch.launch.train import main as train_main

    ck = str(tmp_path / "a")
    full = train_main(SMOKE + ["--steps", "14"])
    part1 = train_main(SMOKE + ["--steps", "7", "--total-steps", "14",
                                "--ckpt-dir", ck, "--ckpt-every", "7"])
    part2 = train_main(SMOKE + ["--steps", "14", "--ckpt-dir", ck,
                                "--resume", "auto"])
    assert len(part2["losses"]) == 7
    combined = part1["losses"] + part2["losses"]
    np.testing.assert_allclose(combined, full["losses"], rtol=1e-4)
    assert CheckpointManager(ck).all_steps() == [7, 14]
    assert len(full["step_s"]) == 14


def test_port_steps_give_the_reference_drivers_losses():
    """Five port train steps from the reference's initial state over
    ``SyntheticSource`` batches give the losses of the reference's
    ``launch.train.main`` (rtol 1e-4)."""
    import jax

    from repro.configs import get_arch as r_get_arch
    from repro.launch.train import main as r_train_main
    from repro.models import get_model as r_get_model
    from repro.optim import AdamWConfig as RAdamWConfig
    from repro.training import steps as r_steps
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import to_device
    from repro_torch.models import get_model
    from repro_torch.models.convert import load_reference_train_state
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import steps as tsteps

    steps = 5
    ref = r_train_main(["--arch", "stablelm-1.6b", "--smoke", "--steps",
                        str(steps), "--batch", "2", "--seq", "32",
                        "--log-every", "100"])
    rmodel = r_get_model(r_get_arch("stablelm-1.6b").smoke())
    state0 = jax.tree.map(np.asarray, jax.jit(
        lambda: r_steps.init_train_state(rmodel, jax.random.PRNGKey(0),
                                         RAdamWConfig()))())
    model = get_model(get_arch("stablelm-1.6b").smoke(), device="cpu")
    state = load_reference_train_state(model, state0)
    step = tsteps.build_train_step(model, AdamWConfig(
        lr=3e-4, total_steps=steps, warmup_steps=1))
    src = SyntheticSource(model.cfg.vocab_size, seed=0)
    losses = []
    for i in range(steps):
        state, metrics = step(state, to_device(src.batch_at(i, 2, 32),
                                               model.device))
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4)
