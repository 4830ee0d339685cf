"""Determinism and plan-cache races in the port (CPU): twin of
``tests/test_determinism.py``.

``repro_torch.tune``'s search must be a pure function of its inputs —
identical plans across repeat runs, equal to the reference's, and equal
after a JSON cache round trip — and its plan cache must survive
concurrent writers on the same key: the atomic temp-file + ``os.replace``
protocol may lose a racing update but never corrupts the store or serves
a torn plan.  Every store lives under ``tmp_path``.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import repro.tune as RT
from repro_torch.tune import (AutoTuner, PlanCache, TunedPlan, gpu_profile,
                              search_factor, search_gemm)
from repro_torch.tune.cache import SCHEMA_VERSION

CPU = "cpu"
# a narrower space than the default keeps each search well under a second
OPTS = dict(nbuf_options=(1, 2), traversal_options=("col", "serpentine"),
            max_steps=256)


def test_search_gemm_repeat_runs_identical():
    args = (2048, 2048, 1024, 8_000_000, gpu_profile())
    plans = [search_gemm(*args, fingerprint="det", **OPTS) for _ in range(3)]
    assert plans[0] == plans[1] == plans[2]
    ref = RT.search_gemm(2048, 2048, 1024, 8_000_000, RT.gpu_profile(),
                         fingerprint="det", **OPTS)
    assert plans[0].to_json() == ref.to_json()


def test_search_factor_repeat_runs_identical():
    args = ("cholesky", 2048, 256, 64 * 2**20, gpu_profile())
    a = search_factor(*args, fingerprint="det")
    b = search_factor(*args, fingerprint="det")
    assert a == b
    assert a.kernel == "cholesky-factor"
    assert a.param("lookahead") in (0, 1, 2)
    ref = RT.search_factor("cholesky", 2048, 256, 64 * 2**20,
                           RT.gpu_profile(), fingerprint="det")
    assert a.to_json() == ref.to_json()


@pytest.mark.parametrize("kw", [{"nstreams_options": (1,)},
                                {"lookahead_options": (1, 2)}])
def test_search_factor_baseline_finite_under_restricted_options(kw):
    """baseline_makespan stays finite (and JSON-portable) even when the
    hardcoded (ns=2, nb=2, la=0) default is outside the option sets."""
    plan = search_factor("cholesky", 1024, 128, 32 * 2**20, gpu_profile(),
                         fingerprint="b", **kw)
    assert np.isfinite(plan.baseline_makespan)
    assert plan.makespan <= plan.baseline_makespan + 1e-12
    assert TunedPlan.from_json(json.loads(
        json.dumps(plan.to_json()))) == plan
    assert plan.to_json() == RT.search_factor(
        "cholesky", 1024, 128, 32 * 2**20, RT.gpu_profile(),
        fingerprint="b", **kw).to_json()


def test_plan_survives_cache_round_trip(tmp_path):
    """put -> fresh instance -> get returns an equal TunedPlan for both the
    GEMM and the factor plan shapes."""
    path = str(tmp_path / "plans.json")
    gemm = search_gemm(1024, 1024, 512, 2_000_000, gpu_profile(),
                       fingerprint="rt", **OPTS)
    factor = search_factor("lu", 1024, 128, 32 * 2**20, gpu_profile(),
                           fingerprint="rt")
    cache = PlanCache(path)
    cache.put("k1", gemm)
    cache.put("k2", factor)
    fresh = PlanCache(path)
    assert fresh.get("k1") == gemm
    assert fresh.get("k2") == factor
    assert fresh.hits == 2 and fresh.misses == 0


def test_reference_store_reads_in_the_port(tmp_path):
    """The two stores share a layout: a store the reference wrote reads in
    the port as equal plans (the port never writes the reference's file;
    this only reads one)."""
    path = str(tmp_path / "reference.json")
    ref = RT.search_gemm(1024, 1024, 512, 2_000_000, RT.gpu_profile(),
                         fingerprint="rt", **OPTS)
    RT.PlanCache(path).put("k", ref)
    got = PlanCache(path).get("k")
    assert got is not None and got.to_json() == ref.to_json()


def test_tuner_plan_identical_after_cache_round_trip(tmp_path):
    """The full tune="auto" path: a plan served from cache equals the plan
    the search produced."""
    def tuner():
        return AutoTuner(profile=gpu_profile(), fingerprint="same",
                         cache=PlanCache(str(tmp_path / "a.json")),
                         max_steps=256, torch_device=CPU)

    t1 = tuner()
    p1 = t1.factor_plan("cholesky", 1024, 128, 32 * 2**20)
    t2 = tuner()
    p2 = t2.factor_plan("cholesky", 1024, 128, 32 * 2**20)
    assert p1 == p2
    assert t2.searches == 0 and t2.last_from_cache


def _any_valid_plan(path, key):
    with open(path) as f:
        data = json.load(f)           # parseable — never torn
    assert data["schema"] == SCHEMA_VERSION
    plans = data["plans"]
    assert key in plans
    plan = TunedPlan.from_json(plans[key])
    assert plan.kernel == "gemm"
    return plan


def _plans(prefix):
    return [search_gemm(1024, 1024, 512, 2_000_000, gpu_profile(),
                        fingerprint=f"{prefix}{i}", **OPTS)
            for i in range(2)]


def test_cache_survives_racing_writers_same_instance(tmp_path):
    """Two threads hammering ONE PlanCache on the same key: every write
    completes, the file stays valid JSON, and the surviving value is one of
    the written plans."""
    path = str(tmp_path / "race.json")
    cache = PlanCache(path)
    plans = _plans("w")
    with ThreadPoolExecutor(max_workers=2) as pool:
        futs = [pool.submit(lambda p=p: [cache.put("hot", p)
                                         for _ in range(25)])
                for p in plans]
        for f in futs:
            f.result()                # raises if a writer crashed
    got = _any_valid_plan(path, "hot")
    assert got in plans


def test_cache_survives_racing_writer_instances(tmp_path):
    """Two PlanCache instances (two "processes") racing on the same store
    path: os.replace keeps the file atomic — a racing update may lose, the
    store never corrupts."""
    path = str(tmp_path / "race2.json")
    plans = _plans("i")

    def writer(i):
        c = PlanCache(path)
        for _ in range(25):
            c.put("hot", plans[i])
            c._mem = None             # drop the memo: re-read like a fresh
        return True                   # process would

    with ThreadPoolExecutor(max_workers=2) as pool:
        assert all(f.result() for f in
                   [pool.submit(writer, i) for i in range(2)])
    got = _any_valid_plan(path, "hot")
    assert got in plans
    assert PlanCache(path).get("hot") in plans


def test_racing_distinct_keys_do_not_corrupt(tmp_path):
    """Writers on distinct keys through one instance: both keys land (the
    in-instance lock serializes load-modify-store)."""
    path = str(tmp_path / "race3.json")
    cache = PlanCache(path)
    plan = search_gemm(512, 512, 256, 1_000_000, gpu_profile(),
                       fingerprint="x", **OPTS)
    with ThreadPoolExecutor(max_workers=4) as pool:
        futs = [pool.submit(cache.put, f"key{i}", plan) for i in range(8)]
        for f in futs:
            f.result()
    with open(path) as f:
        data = json.load(f)
    assert set(data["plans"]) == {f"key{i}" for i in range(8)}
    assert len(cache) == 8
