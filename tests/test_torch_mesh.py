"""The MESH tier's SUMMA ring, ``direct_mesh_ooc_gemm`` and
``compressed_pod_psum`` on 2 and 4 gloo ranks of the CPU, held against the
reference's ``MeshOocRuntime`` and ``compressed_pod_psum`` under
``shard_map`` on as many forced host devices (one subprocess: XLA pins the
host device count at its first use, and this process keeps one device).

The ring's products are kernel 1's plain version here; on the card they
are kernel 1 (``tests/test_torch_card.py``, ``chip_smoke.py`` phase 16).
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from _torch_dist import compress_rank, in_turn, ring_rank, run_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLDS = (2, 4)
DTYPES = ("float32", "bfloat16")
ALPHA, BETA = 1.5, 0.5
TOL = {"float32": 1e-4, "bfloat16": 2e-2}     # the reference GEMM tests'
M, N, K = 64, 48, 40

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np, ml_dtypes
from jax.sharding import Mesh, PartitionSpec as P
from repro.core.runtime import MeshOocRuntime
from repro.optim import compression

d = sys.argv[1]
case = np.load(os.path.join(d, "case.npz"))
for w in (2, 4):
    mesh = Mesh(np.array(jax.devices()[:w]), ("model",))
    for dt in ("float32", "bfloat16"):
        t = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}[dt]
        A, B, C = (jnp.asarray(case[k].astype(t)) for k in "ABC")
        for ov in (True, False):
            out = MeshOocRuntime(mesh).gemm(A, B, C, 1.5, 0.5, overlap=ov)
            np.save(os.path.join(d, f"ring_{w}_{dt}_{ov}.npy"),
                    np.asarray(out).astype(np.float32))
    pm = Mesh(np.array(jax.devices()[:w]), ("pod",))
    g = {k: jnp.asarray(case[f"g{w}_{k}"]) for k in ("a", "b")}
    e = {k: jnp.asarray(case[f"e{w}_{k}"]) for k in ("a", "b")}
    fn = jax.shard_map(
        lambda g_, e_: compression.compressed_pod_psum(
            {k: v[0] for k, v in g_.items()},
            {k: v[0] for k, v in e_.items()}),
        mesh=pm, in_specs=(P("pod"), P("pod")),
        out_specs=(P(), P("pod")), check_vma=False)
    mean, err = jax.jit(fn)(g, e)
    for k in ("a", "b"):
        np.save(os.path.join(d, f"mean_{w}_{k}.npy"), np.asarray(mean[k]))
        np.save(os.path.join(d, f"err_{w}_{k}.npy"), np.asarray(err[k]))
print("ok")
"""


def _grads(w, rng):
    return ({"a": rng.standard_normal((w, 6, 5)).astype(np.float32),
             "b": rng.standard_normal((w, 11)).astype(np.float32) * 3},
            {"a": rng.standard_normal((w, 6, 5)).astype(np.float32) * 1e-2,
             "b": rng.standard_normal((w, 11)).astype(np.float32) * 1e-2})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The case, the reference's results and the port's, per world."""
    d = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(24)
    case = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in (("A", (M, K)), ("B", (K, N)), ("C", (M, N)))}
    grads = {w: _grads(w, rng) for w in WORLDS}
    for w, (g, e) in grads.items():
        for k in ("a", "b"):
            case[f"g{w}_{k}"], case[f"e{w}_{k}"] = g[k], e[k]
    np.savez(d / "case.npz", **case)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(d)],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    port = {}
    for w in WORLDS:
        cases = [(case["A"], case["B"], case["C"], ALPHA, BETA, dt)
                 for dt in DTYPES]
        g, e = grads[w]
        per_rank = ([{k: g[k][r] for k in g} for r in range(w)],
                    [{k: e[k][r] for k in e} for r in range(w)])
        both = run_ranks(in_turn, w, (ring_rank, (cases,)),
                         (compress_rank, per_rank))
        port[w] = ([r[0] for r in both], [r[1] for r in both])
    out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    return d, case, grads, port


def _ref(d, name):
    return np.load(d / f"{name}.npy")


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "serial"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_ring_matches_reference(runs, world, dtype, overlap):
    d, case, _, port = runs
    rank0 = port[world][0][0][DTYPES.index(dtype)]
    ref = _ref(d, f"ring_{world}_{dtype}_{overlap}")
    tol = TOL[dtype]
    np.testing.assert_allclose(rank0[overlap], ref, rtol=tol, atol=tol)
    # each rank holds its row block and sent its B block to n - 1 ranks
    assert rank0[f"local{overlap}"] == (M // world, N)
    bpe = 4 if dtype == "float32" else 2
    assert rank0[f"bytes{overlap}"] == (world - 1) * K * (N // world) * bpe


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("world", WORLDS)
def test_direct_mesh_ring_equals_the_tier_bitwise(runs, world, dtype):
    """The standalone ring, the tier (overlapped and serial) and
    ``ooc_gemm(backend="mesh")`` agree bit for bit on every rank."""
    _, _, _, port = runs
    i = DTYPES.index(dtype)
    for rank in port[world][0]:
        res = rank[i]
        for other in (False, "direct", "api"):
            np.testing.assert_array_equal(res[other], res[True])
    np.testing.assert_array_equal(port[world][0][-1][i][True],
                                  port[world][0][0][i][True])


@pytest.mark.parametrize("world", WORLDS)
def test_compressed_pod_psum_matches_reference(runs, world):
    """Payloads equal to the reference's quantization under the shared
    scale (the largest pod scale), means within 1e-6 of the reference's
    on every rank, errors within 1e-6 per pod."""
    d, _, grads, port = runs
    g, e = grads[world]
    results = port[world][1]
    for k in ("a", "b"):
        corrected = g[k] + e[k]
        scale = max(float(np.abs(c).max()) / 127.0 + 1e-12
                    for c in corrected)
        scale = np.float32(scale)
        want_q = np.clip(np.round(corrected / scale), -127, 127).astype(
            np.int8)
        ref_mean = _ref(d, f"mean_{world}_{k}")
        # the pods' errors, concatenated along dim 0 by the out_specs
        ref_err = _ref(d, f"err_{world}_{k}").reshape(g[k].shape)
        for r, (mean, err, q) in enumerate(results):
            np.testing.assert_array_equal(q[k], want_q[r])
            np.testing.assert_allclose(mean[k], ref_mean, rtol=0, atol=1e-6)
            np.testing.assert_allclose(err[k], ref_err[r], rtol=0,
                                       atol=1e-6)
