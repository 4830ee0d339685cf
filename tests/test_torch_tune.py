"""The port's autotuner against the reference's (CPU): twin of
``tests/test_tune.py``.

The same problems go through ``repro.tune`` and ``repro_torch.tune``: the
canned profiles build the same engine models, the search spaces hold the
same candidates in the same order, and for one profile ``search_gemm``,
``search_factor`` and ``search_attention`` return plans whose
``to_json()`` equals the reference's, makespans included (the planning
layers are equal op for op, so any difference is a bug).  Tuned entry
points run on the CPU (``torch_device="cpu"``, one BLAS thread) and are
held to the reference's outputs at its tolerances and to the port's
untuned output bit for bit wherever the partition keeps each element's
sum over K in one order.  No test touches the home directory: every tuner
has a plan cache under ``tmp_path`` and an injected profile, except the
calibration tests, which measure this CPU.
"""

import dataclasses
import importlib
import inspect
import json

import numpy as np
import pytest
import torch

import repro.core as R
import repro.tune as RT
import repro_torch.core as T
import repro_torch.tune as TT
from repro.core.ooc_factor import ooc_cholesky as R_ooc_cholesky
from repro.core.ooc_factor import ooc_lu as R_ooc_lu
from repro.obs import get_observability as R_obs
from repro_torch.obs import get_observability

from _torch_helpers import one_torch_thread  # noqa: F401 (autouse)

CPU = "cpu"
# paper §VI regime for C5: compute-dominated large square DGEMM
C5_SHAPE = (8192, 8192, 8192)
C5_BUDGET = (3 * 8192 * 8192) * 8 // 6
C5_OPTS = dict(nbuf_options=(1, 2), max_steps=128)  # small space, fast tests
# a narrower space for most equality cases (one case per kernel searches
# the full default space)
FAST = dict(nbuf_options=(1, 2), traversal_options=("col", "serpentine"),
            max_steps=256)
PROFILES = ["gpu_profile", "phi_profile"]


@pytest.fixture(autouse=True)
def _clean_obs():
    for obs in (get_observability(), R_obs()):
        obs.reset().disable()
    yield
    for obs in (get_observability(), R_obs()):
        obs.reset().disable()


def _tuner(mod, profile, tmp_path, name="fp", **kw):
    opts = {**C5_OPTS, "fingerprint": name, **kw}
    if mod is TT:
        opts["torch_device"] = CPU
    return mod.AutoTuner(profile=profile,
                         cache=mod.PlanCache(str(tmp_path / f"{name}.json")),
                         **opts)


def _port_tuner(tmp_path, name="port", profile=None):
    return _tuner(TT, profile or TT.gpu_profile(), tmp_path, name)


def _ref_tuner(tmp_path, name="port"):
    """The reference's tuner on the same profile, options and fingerprint
    as :func:`_port_tuner`'s (its own cache file)."""
    return _tuner(RT, RT.gpu_profile(), tmp_path, name + "-ref",
                  fingerprint=name)


def _cand(c):
    """A candidate's fields as plain values (the partition classes of the
    two packages differ)."""
    return (dataclasses.astuple(c.part),) + tuple(
        getattr(c, f.name) for f in dataclasses.fields(c) if f.name != "part")


# --------------------------------------------------------------- profiles
def test_canned_profiles_match_simulator_models():
    """phi/gpu profiles instantiate the port simulator's hand-entered
    models engine for engine, and every canned profile equals the
    reference's field for field (simulation inputs, not measurements)."""
    for ns in (1, 2):
        got = TT.phi_profile().model_for(ns)
        want = T.phi_like(nstreams=ns)
        assert got.pools == want.pools
        assert got.kind_pool == want.kind_pool
        assert got.compute_split == want.compute_split
        assert got.split_efficiency == want.split_efficiency
        assert (got.h2d_bw, got.d2h_bw, got.flops) == \
            (want.h2d_bw, want.d2h_bw, want.flops)
    assert TT.gpu_profile().model_for(2).pools == T.gpu_like().pools
    assert TT.gpu_profile().model_for(1).pools == T.gpu_like().pools
    tpu = TT.tpu_v5e_profile().model_for(2)
    assert tpu.per_op_overhead == R.tpu_v5e_vmem().per_op_overhead
    assert tpu.pools == {"h2d": 1, "d2h": 1, "exec": 1}
    for name in ("gpu_profile", "phi_profile", "tpu_v5e_profile"):
        mine, ref = getattr(TT, name)(), getattr(RT, name)()
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        for ns in (1, 2, 3):
            a, b = mine.model_for(ns), ref.model_for(ns)
            assert (a.name, a.pools, a.h2d_bw, a.d2h_bw, a.flops,
                    a.per_op_overhead, a.compute_split,
                    a.split_efficiency) == (
                b.name, b.pools, b.h2d_bw, b.d2h_bw, b.flops,
                b.per_op_overhead, b.compute_split, b.split_efficiency)
            assert {k.name: v for k, v in a.kind_pool.items()} == \
                {k.name: v for k, v in b.kind_pool.items()}


def test_public_names_are_the_references():
    assert TT.__all__ == RT.__all__
    assert all(hasattr(TT, n) for n in TT.__all__)


# ------------------------------------------------------------------- space
@pytest.mark.parametrize("M,N,K,div,bpe", [
    (2048, 2048, 1024, 4, 4), (640, 512, 256, 4, 4), (1000, 777, 300, 3, 2),
    (8192, 8192, 8192, 6, 8), (24576, 24576, 24576, 3, 4)])
def test_gemm_search_space_matches_reference(M, N, K, div, bpe):
    budget = (M * K + K * N + M * N) * bpe // div
    for kw in ({}, dict(nbuf_options=(1, 2), max_steps=128),
               dict(nstreams_options=(1, 2, 3), evict_options=("lru",))):
        mine = TT.gemm_search_space(M, N, K, budget, bpe, **kw)
        ref = RT.gemm_search_space(M, N, K, budget, bpe, **kw)
        assert mine and [_cand(c) for c in mine] == [_cand(c) for c in ref]


@pytest.mark.parametrize("S,hkv,d,budget,bpe", [
    (2048, 4, 64, 1 << 20, 4), (524288, 8, 128, 512 << 20, 2),
    (5000, 2, 80, 300_000, 2), (131072, 8, 128, 256 << 20, 4)])
def test_attention_search_space_matches_reference(S, hkv, d, budget, bpe):
    mine = TT.attention_search_space(S, hkv, d, budget, bpe)
    ref = RT.attention_search_space(S, hkv, d, budget, bpe)
    assert mine and [_cand(c) for c in mine] == [_cand(c) for c in ref]


def test_space_respects_generalized_working_set():
    M, N, K = 2048, 2048, 1024
    budget = (M * K + K * N + M * N) * 4 // 4
    space = TT.gemm_search_space(M, N, K, budget, 4, nbuf_options=(1, 2, 3))
    assert space, "space must not be empty"
    for cand in space:
        if not cand.baseline:
            assert cand.part.working_set_bytes(cand.nbuf, cand.nstreams) \
                <= budget
    default = T.plan_gemm_partition(M, N, K, budget, 4)
    assert any(c.baseline and c.part.bm == default.bm
               and c.part.bn == default.bn
               and c.nstreams == 2 and c.nbuf == 2 for c in space)


# ---------------------------------------------------------------- searches
@pytest.mark.parametrize("kernel,M,N,K,div,dtype,profile,fault_rate,opts", [
    ("gemm", 640, 512, 256, 4, "float32", "gpu_profile", 0.0, {}),
    ("gemm", 640, 512, 256, 4, "float32", "phi_profile", 0.05, FAST),
    ("gemm", 1000, 777, 300, 3, "bfloat16", "phi_profile", 0.0, FAST),
    ("gemm", 1000, 777, 300, 3, "bfloat16", "gpu_profile", 0.05, FAST),
    ("gemm", 4096, 2048, 3072, 6, "float64", "gpu_profile", 0.0, C5_OPTS),
    ("gemm", 4096, 2048, 3072, 6, "float64", "phi_profile", 0.05, C5_OPTS),
    ("gemm", 24576, 24576, 24576, 3, "float32", "gpu_profile", 0.0,
     dict(C5_OPTS, max_steps=64)),
    ("syrk", 768, 768, 320, 4, "float32", "gpu_profile", 0.05, {}),
    ("syrk", 768, 768, 320, 4, "float16", "phi_profile", 0.0, FAST)])
def test_search_gemm_matches_reference(kernel, M, N, K, div, dtype, profile,
                                       fault_rate, opts):
    bpe = TT.search.dtype_itemsize(dtype)
    budget = (M * K + K * N + M * N) * bpe // div
    kw = dict(kernel=kernel, dtype=dtype, fingerprint="fp",
              fault_rate=fault_rate, **opts)
    mine = TT.search_gemm(M, N, K, budget, getattr(TT, profile)(), **kw)
    ref = RT.search_gemm(M, N, K, budget, getattr(RT, profile)(), **kw)
    assert mine.to_json() == ref.to_json()
    assert mine.makespan <= mine.baseline_makespan + 1e-12


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("fault_rate", [0.0, 0.02])
@pytest.mark.parametrize("kind,n,panel,budget", [
    ("cholesky", 2048, 256, 64 << 20), ("lu", 1024, 128, 32 << 20),
    ("cholesky", 1000, 192, 3 << 20), ("lu", 768, 256, 4 << 20)])
def test_search_factor_matches_reference(profile, fault_rate, kind, n,
                                         panel, budget):
    kw = dict(fingerprint="fp", fault_rate=fault_rate)
    mine = TT.search_factor(kind, n, panel, budget, getattr(TT, profile)(),
                            **kw)
    ref = RT.search_factor(kind, n, panel, budget, getattr(RT, profile)(),
                           **kw)
    assert mine.to_json() == ref.to_json()


@pytest.mark.parametrize("profile", PROFILES + ["tpu_v5e_profile"])
@pytest.mark.parametrize("S,hkv,d,H,budget,dtype", [
    (2048, 4, 64, 8, 1 << 19, "float32"),
    (524288, 8, 128, 24, 512 << 20, "bfloat16"),
    (5000, 2, 80, 6, 300_000, "float16")])
def test_search_attention_matches_reference(profile, S, hkv, d, H, budget,
                                            dtype):
    mine = TT.search_attention(S, hkv, d, H, budget, getattr(TT, profile)(),
                               dtype=dtype, fingerprint="fp")
    ref = RT.search_attention(S, hkv, d, H, budget, getattr(RT, profile)(),
                              dtype=dtype, fingerprint="fp")
    assert mine.to_json() == ref.to_json()


# ---------------------------------------------------------- C5 acceptance
def test_c5_phi_selects_one_stream_gpu_two(tmp_path):
    M, N, K = C5_SHAPE
    phi = _tuner(TT, TT.phi_profile(), tmp_path, "phi")
    gpu = _tuner(TT, TT.gpu_profile(), tmp_path, "gpu")

    p_phi = phi.gemm_plan(M, N, K, C5_BUDGET, dtype="float64")
    p_gpu = gpu.gemm_plan(M, N, K, C5_BUDGET, dtype="float64")

    assert p_phi.nstreams == 1, "Phi-like hardware must run 1 stream (C5)"
    assert p_gpu.nstreams == 2, "GPU-like hardware must run 2 streams (C5)"
    assert p_phi.makespan <= p_phi.baseline_makespan + 1e-12
    assert p_gpu.makespan <= p_gpu.baseline_makespan + 1e-12
    for mod_prof, plan, name in ((RT.phi_profile(), p_phi, "phi"),
                                 (RT.gpu_profile(), p_gpu, "gpu")):
        ref = _tuner(RT, mod_prof, tmp_path, f"ref-{name}").gemm_plan(
            M, N, K, C5_BUDGET, dtype="float64")
        assert dataclasses.replace(ref, fingerprint=name).to_json() == \
            plan.to_json()

    for tuner, plan in ((phi, p_phi), (gpu, p_gpu)):
        searches = tuner.searches
        again = tuner.gemm_plan(M, N, K, C5_BUDGET, dtype="float64")
        assert tuner.last_from_cache
        assert tuner.searches == searches
        assert again == plan


def test_c5_baseline_agrees_with_simulator():
    M, N, K = C5_SHAPE
    plan = TT.search_gemm(M, N, K, C5_BUDGET, TT.phi_profile(),
                          dtype="float64", fingerprint="x", **C5_OPTS)
    dpart = T.plan_gemm_partition(M, N, K, C5_BUDGET, 8)
    want = T.simulate(T.build_gemm_schedule(dpart, 2, 2),
                      TT.phi_profile().model_for(2)).makespan
    assert plan.baseline_makespan == pytest.approx(want, rel=1e-12)
    got = T.simulate(T.build_gemm_schedule(plan.gemm_partition(),
                                           plan.nstreams, plan.nbuf,
                                           write_back=plan.write_back,
                                           traversal=plan.traversal,
                                           evict=plan.evict),
                     TT.phi_profile().model_for(plan.nstreams)).makespan
    assert plan.makespan == pytest.approx(got, rel=1e-12)


# ------------------------------------------------------------ determinism
def test_search_is_deterministic(tmp_path):
    M, N, K = 1024, 768, 512
    budget = (M * K + K * N + M * N) * 4 // 5
    a = TT.search_gemm(M, N, K, budget, TT.gpu_profile(), fingerprint="fp",
                       **FAST)
    b = TT.search_gemm(M, N, K, budget, TT.gpu_profile(), fingerprint="fp",
                       **FAST)
    assert a == b
    t1 = _tuner(TT, TT.gpu_profile(), tmp_path, "d1")
    t2 = _tuner(TT, TT.gpu_profile(), tmp_path, "d2")
    p1 = t1.gemm_plan(M, N, K, budget)
    p2 = t2.gemm_plan(M, N, K, budget)
    assert dataclasses.replace(p1, fingerprint="") == \
        dataclasses.replace(p2, fingerprint="")


def test_plan_json_roundtrip():
    plan = TT.search_gemm(1024, 1024, 512, 2_000_000, TT.gpu_profile(),
                          fingerprint="rt", **C5_OPTS)
    again = TT.TunedPlan.from_json(json.loads(json.dumps(plan.to_json())))
    assert again == plan
    part = again.gemm_partition()
    assert (part.bm, part.bn, part.h, part.w) == \
        (plan.param("bm"), plan.param("bn"), plan.param("h"),
         plan.param("w"))
    # a reference plan's JSON reads as the same port plan
    ref = RT.search_gemm(1024, 1024, 512, 2_000_000, RT.gpu_profile(),
                         fingerprint="rt", **C5_OPTS)
    assert TT.TunedPlan.from_json(json.loads(json.dumps(ref.to_json()))) \
        == plan
    attn = TT.search_attention(4096, 2, 64, 4, 1 << 20, TT.gpu_profile(),
                               dtype="bfloat16")
    apart = TT.TunedPlan.from_json(attn.to_json()).attention_partition()
    assert (apart.bs, apart.nblocks, apart.bytes_per_el) == \
        (attn.param("bs"), attn.param("nblocks"), 2)
    with pytest.raises(ValueError, match="no KV partition"):
        plan.attention_partition()
    with pytest.raises(ValueError, match="no GEMM partition"):
        attn.gemm_partition()


@pytest.mark.parametrize("dtype,name,size", [
    (torch.float32, "float32", 4), (torch.bfloat16, "bfloat16", 2),
    (np.float64, "float64", 8), ("float16", "float16", 2),
    ("bfloat16", "bfloat16", 2), (np.dtype(np.int32), "int32", 4)])
def test_dtype_names_are_numpys(dtype, name, size):
    """One spelling per dtype in plans and cache keys, as the reference's
    ``np.dtype(dtype).name`` gives it, whether a torch or numpy dtype or a
    name comes in."""
    assert TT.search.dtype_name(dtype) == name
    assert TT.search.dtype_itemsize(dtype) == size


# -------------------------------------------------------------- plan cache
def test_cache_persists_across_tuner_instances(tmp_path):
    path = tmp_path / "shared.json"

    def tuner(fp):
        return TT.AutoTuner(profile=TT.gpu_profile(),
                            cache=TT.PlanCache(str(path)), fingerprint=fp,
                            torch_device=CPU, **C5_OPTS)

    t1 = tuner("same")
    p1 = t1.gemm_plan(2048, 2048, 1024, 4_000_000)
    assert t1.searches == 1
    t2 = tuner("same")
    p2 = t2.gemm_plan(2048, 2048, 1024, 4_000_000)
    assert t2.searches == 0 and t2.last_from_cache and p2 == p1
    t3 = tuner("other")
    t3.gemm_plan(2048, 2048, 1024, 4_000_000)
    assert t3.searches == 1


def test_cache_key_format():
    args = ("gemm", (8192, 8192, 8192), "float32", "HBM", 1 << 28,
            "abcd1234")
    key = TT.PlanCache.key(*args)
    assert key == "gemm:8192x8192x8192:float32:HBM:268435456:abcd1234"
    assert key == RT.PlanCache.key(*args)
    assert TT.cache.SCHEMA_VERSION == RT.cache.SCHEMA_VERSION


def test_corrupt_cache_is_treated_as_empty(tmp_path):
    path = tmp_path / "broken.json"
    path.write_text("{not json")
    cache = TT.PlanCache(str(path))
    assert cache.get("anything") is None
    assert cache.misses == 1
    # another schema's store reads as empty too
    path.write_text(json.dumps({"schema": 1, "plans": {"k": {}}}))
    assert TT.PlanCache(str(path)).get("k") is None


def test_cache_path_is_the_ports_own(monkeypatch, tmp_path):
    """The port's store never is the reference's file: its own variable,
    its own directory under the cache home."""
    for var in ("REPRO_TORCH_TUNE_CACHE", "REPRO_TUNE_CACHE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert TT.default_cache_path() == str(
        tmp_path / "repro-torch-tune" / "plans.json")
    assert TT.default_cache_path() != RT.default_cache_path()
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "ref.json"))
    assert TT.default_cache_path() == str(
        tmp_path / "repro-torch-tune" / "plans.json")
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "p.json"))
    assert TT.default_cache_path() == str(tmp_path / "p.json")
    assert TT.PlanCache().path == str(tmp_path / "p.json")


# ------------------------------------------------- tune="auto" end to end
def _gemm_problem(rng, M, N, K):
    A = rng.standard_normal((M, K)).astype(np.float32)
    B = rng.standard_normal((K, N)).astype(np.float32)
    C = rng.standard_normal((M, N)).astype(np.float32)
    return A, B, C


def test_ooc_gemm_tune_auto_matches_oracle(tmp_path):
    rng = np.random.default_rng(0)
    M, N, K = 640, 512, 256
    A, B, C = _gemm_problem(rng, M, N, K)
    budget = (A.nbytes + B.nbytes + C.nbytes) // 4
    tuner = _tuner(TT, TT.gpu_profile(), tmp_path, "e2e")
    out = T.ooc_gemm(A, B, C, 1.5, -0.5, budget_bytes=budget, tune="auto",
                     tuner=tuner, torch_device=CPU)
    expect = 1.5 * (A.astype(np.float64) @ B) - 0.5 * C
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-4, atol=1e-4)
    assert tuner.searches == 1
    out2 = T.ooc_gemm(A, B, C, 1.5, -0.5, budget_bytes=budget, tune="auto",
                      tuner=tuner, torch_device=CPU)
    assert tuner.searches == 1 and tuner.last_from_cache
    assert torch.equal(out2, out)
    # the reference's tuned run, and the port's untuned run bit for bit
    # (K is never split, and the plain path sums each element in one order)
    rtuner = _ref_tuner(tmp_path, "e2e")
    ref = R.ooc_gemm(A, B, C, 1.5, -0.5, budget_bytes=budget, tune="auto",
                     tuner=rtuner)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)
    assert tuner.gemm_plan(M, N, K, budget).to_json() == \
        rtuner.gemm_plan(M, N, K, budget).to_json()
    untuned = T.ooc_gemm(A, B, C, 1.5, -0.5, budget_bytes=budget,
                         torch_device=CPU)
    assert torch.equal(out, untuned)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16])
def test_ooc_syrk_tune_auto(tmp_path, dtype):
    rng = np.random.default_rng(1)
    n, K = 768, 320
    P = rng.standard_normal((n, K)).astype(dtype)
    C = rng.standard_normal((n, n)).astype(dtype)
    budget = (2 * P.nbytes + C.nbytes) // 4
    tuner = _port_tuner(tmp_path)
    out = T.ooc_syrk(P, C, 1.0, 0.5, budget_bytes=budget, tune="auto",
                     tuner=tuner, torch_device=CPU)
    plan = tuner.syrk_plan(n, K, budget, dtype=dtype)
    assert plan.kernel == "syrk" and tuner.last_from_cache
    ref = R.ooc_syrk(P, C, 1.0, 0.5, budget_bytes=budget, tune="auto",
                     tuner=_ref_tuner(tmp_path))
    tol = 2e-2 if dtype == np.float16 else 1e-4
    assert out.dtype == torch.from_numpy(ref).dtype
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol * np.abs(ref).max())
    untuned = T.ooc_syrk(P, C, 1.0, 0.5, budget_bytes=budget,
                         torch_device=CPU)
    assert torch.equal(out, untuned)


def test_ooc_gemm_rejects_unknown_tune_mode():
    A = np.zeros((64, 64), np.float32)
    for fn, args in ((T.ooc_gemm, (A, A)), (T.ooc_syrk, (A,)),
                     (T.ooc_cholesky, (A,)), (T.ooc_lu, (A,))):
        with pytest.raises(ValueError, match="tune mode"):
            fn(*args, budget_bytes=1 << 20, tune="bogus", torch_device=CPU)
    with pytest.raises(ValueError, match="tune mode"):
        T.ooc_attention(A, A.reshape(64, 1, 64), A.reshape(64, 1, 64),
                        budget_bytes=1 << 20, tune="bogus", torch_device=CPU)


def test_ooc_attention_tune_auto_matches_default(tmp_path):
    rng = np.random.default_rng(2)
    S, hkv, d, H = 2048, 4, 64, 8
    q = rng.standard_normal((H, d)).astype(np.float32)
    k = rng.standard_normal((S, hkv, d)).astype(np.float32)
    v = rng.standard_normal((S, hkv, d)).astype(np.float32)
    budget = k.nbytes // 4
    tuner = _port_tuner(tmp_path, "attn")
    tuned = T.ooc_attention(q, k, v, budget_bytes=budget, tune="auto",
                            tuner=tuner, torch_device=CPU)
    default = T.ooc_attention(q, k, v, budget_bytes=budget,
                              torch_device=CPU)
    np.testing.assert_allclose(tuned.numpy(), default.numpy(), rtol=2e-3,
                               atol=2e-3)
    assert tuner.searches == 1
    again = T.ooc_attention(q, k, v, budget_bytes=budget, tune="auto",
                            tuner=tuner, torch_device=CPU)
    assert tuner.searches == 1 and tuner.last_from_cache
    assert torch.equal(again, tuned)
    rtuner = _ref_tuner(tmp_path, "attn")
    ref = np.asarray(R.ooc_attention(q, k, v, budget_bytes=budget,
                                     tune="auto", tuner=rtuner))
    np.testing.assert_allclose(tuned.numpy(), ref, rtol=1e-4, atol=1e-4)
    assert rtuner.attention_plan(S, hkv, d, H, budget, "float32").to_json() \
        == tuner.attention_plan(S, hkv, d, H, budget, "float32").to_json()


def _spd(rng, n):
    Mx = rng.standard_normal((n, n))
    return (Mx @ Mx.T + n * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("kind", ["cholesky", "lu"])
@pytest.mark.parametrize("n,panel,div", [(320, 128, 3), (512, 64, 4)])
def test_ooc_factor_tune_auto(tmp_path, kind, n, panel, div):
    """Tuned factorizations against the reference's tuned run (same plan)
    at its tolerance, and bit for bit against the port's untuned run at
    the tuned panel width: each trailing element is updated panel after
    panel, each update one sum over the panel's width in one order,
    whatever the blocks and the lookahead."""
    rng = np.random.default_rng(3)
    A = _spd(rng, n) if kind == "cholesky" \
        else rng.standard_normal((n, n)).astype(np.float32)
    budget = A.nbytes // div
    tuner = _port_tuner(tmp_path, "factor")
    fn = T.ooc_cholesky if kind == "cholesky" else T.ooc_lu
    rfn = R_ooc_cholesky if kind == "cholesky" else R_ooc_lu
    res = fn(A, panel=panel, budget_bytes=budget, tune="auto", tuner=tuner,
             torch_device=CPU)
    plan = tuner.factor_plan(kind, n, panel, budget)
    assert tuner.searches == 1 and tuner.last_from_cache
    rtuner = _ref_tuner(tmp_path, "factor")
    ref = rfn(A, panel=panel, budget_bytes=budget, tune="auto",
              tuner=rtuner)
    assert rtuner.factor_plan(kind, n, panel, budget).to_json() == \
        plan.to_json()
    untuned = fn(A, panel=plan.param("panel"), budget_bytes=budget,
                 torch_device=CPU)
    if kind == "cholesky":
        L = res.numpy()
        np.testing.assert_allclose(L @ L.T, A, rtol=2e-3, atol=2e-3)
        assert np.abs(L - ref).max() <= 5e-6 * np.abs(ref).max()
        assert torch.equal(res, untuned)
    else:
        LU, perm = res
        assert np.array_equal(perm.numpy(), ref[1])
        np.testing.assert_allclose(LU.numpy(), ref[0], rtol=0,
                                   atol=1e-4 * np.abs(ref[0]).max())
        assert torch.equal(LU, untuned[0]) and torch.equal(perm, untuned[1])


@pytest.mark.parametrize("kind", ["cholesky", "lu"])
def test_tuned_factor_on_a_card_searches_the_charged_budget(tmp_path, kind):
    """On a card the tuned factorization searches at the budget less the
    panel ops' workspace at the requested panel width (the most any
    candidate's narrower panel needs), the cache key carries that charged
    budget, and the spec fits it; on the CPU the charge is 0 and the plan
    is the reference's at the full budget.  Planning needs no card."""
    from repro_torch.core.ooc_factor import (_tuned_factor_spec,
                                             panel_workspace_bytes)

    n, panel, budget = 4096, 512, 160 << 20
    tuner = _port_tuner(tmp_path, "charged")
    ws = panel_workspace_bytes(kind, n, panel, 4, "cuda")
    spec, ns, nb, ev, plan = _tuned_factor_spec(
        tuner, kind, n, panel, budget, 4, torch.float32, "cuda")
    assert plan.budget == budget - ws
    key = TT.PlanCache.key(f"{kind}-factor", (n, panel), "float32", "HBM",
                           budget - ws, "charged")
    assert key in tuner.cache
    assert spec.working_set_bytes(nb) + panel_workspace_bytes(
        kind, n, spec.panel, 4, "cuda") <= budget
    assert plan.to_json() == RT.search_factor(
        kind, n, panel, budget - ws, RT.gpu_profile(), fingerprint="charged",
        nbuf_options=(1, 2), max_steps=4096).to_json()
    cpu = _tuned_factor_spec(tuner, kind, n, panel, budget, 4,
                             torch.float32, CPU)[4]
    assert cpu.budget == budget
    with pytest.raises(ValueError, match="panel-op workspace"):
        _tuned_factor_spec(tuner, kind, n, panel, 32 << 20, 4,
                           torch.float32, "cuda")


@pytest.mark.parametrize("kind", ["cholesky", "lu"])
def test_vmem_loop_passes_tune_through(tmp_path, kind):
    """``backend="vmem"`` takes the per-panel loop, and its trailing
    updates take ``tune``/``tuner`` as the reference's do (the vmem
    backend plans its own launch, so nothing is searched)."""
    rng = np.random.default_rng(4)
    A = _spd(rng, 96)
    tuner = _port_tuner(tmp_path, "vmem")
    fn = T.ooc_cholesky if kind == "cholesky" else T.ooc_lu
    tuned = fn(A, panel=32, budget_bytes=1 << 20, backend="vmem",
               tune="auto", tuner=tuner, torch_device=CPU)
    plain = fn(A, panel=32, budget_bytes=1 << 20, backend="vmem",
               torch_device=CPU)
    tuned, plain = (x if isinstance(x, tuple) else (x,)
                    for x in (tuned, plain))
    assert all(torch.equal(a, b) for a, b in zip(tuned, plain))
    assert tuner.searches == 0


def test_tuned_runs_record_drift_and_spans(tmp_path):
    """A tuned run records its measured wall and bytes against the plan's
    prediction (byte ratio exactly 1), and the tuner's decision shows as
    ``tune.plan``/``plancache.get`` spans with a search under the first."""
    obs = get_observability()
    obs.enable(metrics=True, trace=True)
    rng = np.random.default_rng(5)
    A, B, C = _gemm_problem(rng, 512, 384, 256)
    budget = (A.nbytes + B.nbytes + C.nbytes) // 4
    tuner = _port_tuner(tmp_path, "drift")
    for _ in range(2):
        T.ooc_gemm(A, B, C, 1.0, 0.5, budget_bytes=budget, tune="auto",
                   tuner=tuner, torch_device=CPU)
    snap = obs.snapshot()
    recs = [r for r in snap["drift"]["records"] if r["kernel"] == "gemm"]
    assert len(recs) == 2
    assert all(r["byte_ratio"] == 1.0 and r["predicted_makespan"] > 0
               for r in recs)
    names = [s.name for s in obs.tracer.spans()]
    assert names.count("tune.plan") == 2
    assert names.count("plancache.get") == 2
    assert names.count("tune.search") == 1
    # attention and the factorizations record theirs too
    q = rng.standard_normal((4, 64)).astype(np.float32)
    kv = rng.standard_normal((1024, 2, 64)).astype(np.float32)
    T.ooc_attention(q, kv, kv, budget_bytes=kv.nbytes // 2, tune="auto",
                    tuner=tuner, torch_device=CPU)
    T.ooc_cholesky(_spd(rng, 192), panel=64, budget_bytes=192 * 192 * 2,
                   tune="auto", tuner=tuner, torch_device=CPU)
    recs = obs.snapshot()["drift"]["records"]
    assert {r["kernel"] for r in recs} == {"gemm", "attention",
                                           "cholesky-factor"}
    assert all(r["byte_ratio"] == 1.0 for r in recs)
    text = obs.metrics.to_prometheus_text()
    for metric in ("repro_tune_searches_total",
                   "repro_plancache_hits_total",
                   "repro_plancache_misses_total",
                   "repro_tune_candidates_total"):
        assert metric in text


def test_hcl_autotuner_facade(tmp_path):
    from repro_torch.core.api import hclAutoTuner

    dev = T.Device("VMEM", 0, 1 << 20)
    tuner = hclAutoTuner(dev, profile=TT.gpu_profile(), fingerprint="f",
                         cache=TT.PlanCache(str(tmp_path / "f.json")),
                         torch_device=CPU, **C5_OPTS)
    assert isinstance(tuner, TT.AutoTuner) and tuner.tier == "VMEM"
    plan = tuner.gemm_plan(1024, 1024, 512, 2_000_000)
    assert plan.tier == "VMEM" and ":VMEM:" in next(iter(
        json.loads(open(tmp_path / "f.json").read())["plans"]))


def test_default_tuner_is_swappable(tmp_path):
    import repro_torch.tune.tuner as TT_tuner

    saved = TT_tuner._default_tuner
    try:
        TT.set_default_tuner(None)
        a = TT.get_default_tuner()
        assert a is TT.get_default_tuner() and a.torch_device is None
        mine = _port_tuner(tmp_path, "default")
        TT.set_default_tuner(mine)
        rng = np.random.default_rng(6)
        A, B, C = _gemm_problem(rng, 384, 256, 128)
        T.ooc_gemm(A, B, C, budget_bytes=(A.nbytes + B.nbytes) // 2,
                   tune="auto", torch_device=CPU)
        assert mine.searches == 1
    finally:
        TT.set_default_tuner(saved)


# ------------------------------------------------------------- calibration
def test_calibrate_measures_this_machine():
    res = TT.calibrate(small=(128, 512), large=(1024, 512), gemm_n=256,
                       repeats=2, torch_device=CPU)
    prof = res.profile
    for rate in (prof.h2d_bw, prof.d2h_bw, prof.flops):
        assert np.isfinite(rate) and rate > 0
    assert 0 < prof.per_op_overhead <= 1e-3
    assert res.fingerprint == TT.hardware_fingerprint(CPU)
    assert set(res.samples) == {"h2d_small_s", "h2d_large_s", "d2h_small_s",
                                "d2h_large_s", "dgemm_256_s"}
    for ns in (1, 2):
        model = prof.model_for(ns)
        assert model.pools and model.flops > 0


def test_calibrate_defaults_on_the_cpu_are_the_references():
    """On CPU tensors the micro-benchmarks keep the reference's sizes;
    on a card they are sized to it (8 MiB and 128 MiB transfers, a
    4096^3 dgemm)."""
    ref = inspect.signature(RT.calibrate).parameters
    mine = inspect.signature(TT.calibrate).parameters
    assert list(mine)[:len(ref)] == list(ref)
    assert TT.calibrate.__defaults__[0] == ref["tier"].default
    assert mine["repeats"].default == ref["repeats"].default
    defaults = importlib.import_module("repro_torch.tune.calibrate").DEFAULTS
    for name in ("small", "large", "gemm_n"):
        assert defaults["cpu"][name] == ref[name].default
    card = defaults["cuda"]
    assert [r * c * 4 for r, c in (card["small"], card["large"])] == \
        [8 << 20, 128 << 20]
    assert card["gemm_n"] == 4096


def test_calibrate_with_the_cpu_defaults(monkeypatch):
    """``calibrate(torch_device="cpu")`` times the reference's sizes: the
    dgemm sample is named for n = 512."""
    res = TT.calibrate(repeats=1, torch_device=CPU)
    assert "dgemm_512_s" in res.samples
    assert res.profile.name == "calibrated-hbm"


def test_fingerprint_is_stable():
    fp = TT.hardware_fingerprint(CPU)
    assert fp == TT.hardware_fingerprint("cpu")
    assert len(fp) == 16 and int(fp, 16) >= 0


def test_tuner_calibrates_its_device_lazily(monkeypatch, tmp_path):
    """No profile: the first plan calibrates the tuner's device once and
    takes the calibration's fingerprint into the cache key."""
    import repro_torch.tune.tuner as TT_tuner

    calls = []

    def fake(tier, torch_device):
        calls.append((tier, torch_device))
        return TT.CalibrationResult(TT.gpu_profile(), "fake-fp", {})

    monkeypatch.setattr(TT_tuner, "calibrate", fake)
    tuner = TT.AutoTuner(cache=TT.PlanCache(str(tmp_path / "c.json")),
                         torch_device=CPU, **C5_OPTS)
    plan = tuner.gemm_plan(1024, 1024, 512, 2_000_000)
    tuner.gemm_plan(1024, 1024, 512, 2_000_000)
    assert calls == [("HBM", CPU)]
    assert plan.fingerprint == "fake-fp" and tuner.last_from_cache


# ------------------------------------- heap simulator equals its reference
def test_simulate_heap_matches_reference():
    part = T.plan_gemm_partition(1024, 1024, 512, 2_000_000, 4)
    for ns, nb in ((1, 1), (2, 2), (2, 3), (3, 2)):
        sched = T.build_gemm_schedule(part, ns, nb)
        for hw in (T.gpu_like(), T.phi_like(nstreams=ns),
                   TT.tpu_v5e_profile().model_for(ns)):
            a = T.simulate(sched, hw)
            b = T.simulate_reference(sched, hw)
            assert a.makespan == pytest.approx(b.makespan, abs=1e-15)
            assert a.busy == b.busy
            assert sorted(a.op_spans) == sorted(b.op_spans)
