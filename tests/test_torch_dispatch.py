"""The port's GEMM dispatcher (``repro_torch.core.dispatch``) and its Hopper
model (``repro_torch.core.tiling``), mirroring ``tests/test_dispatch.py``
case for case where a case has meaning in the port, and held against the
JAX package's dispatcher where the two share a contract: the keys, the
modes, and one table file holding both packages' entries.

There is no card here, so the tuner's measurement is faked: ``fake_measure``
stands in for ``dispatch._measure_all`` and times the i-th of n candidates
at 100 - i µs with no spread, so the last candidate wins wherever there
are two or more (and the analytic pick, always first, wins alone).  It
records each call, so a test can tell a measurement from a table hit.
"""
import json

import jax.numpy as jnp
import pytest
import torch

from _hypothesis_compat import given, st
from repro.core import dispatch as jax_dispatch
from repro_torch.core import dispatch
from repro_torch.core.tiling import (SMEM_PER_BLOCK, GemmPlan, PlanModel,
                                     choose_plan, smem_bytes)
from repro_torch.kernels.tiled_matmul import ops as matmul_ops
from repro_torch.kernels.tiled_matmul.ops import check_plan, gemm_plan


@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    """Isolated tuner table: a private file, one timed replay, the shipped
    table off, and the fake measurement (its calls in ``calls``)."""
    path = tmp_path / "tune.json"
    monkeypatch.setenv(dispatch.CACHE_ENV, str(path))
    monkeypatch.setenv(dispatch.ITERS_ENV, "1")
    monkeypatch.setenv(dispatch.SEED_ENV, "0")
    monkeypatch.setattr(dispatch, "_measure_all", fake_measure)
    monkeypatch.setattr(dispatch, "card", lambda: "test card, 0 W")
    fake_measure.calls = []
    dispatch.reset_cache_state()
    yield path
    dispatch.reset_cache_state()


def fake_measure(plans, m, ns, k, out_dtype, iters):
    fake_measure.calls.append((m, tuple(ns), k, out_dtype, list(plans)))
    return [(100.0 - i, 0.0) for i in range(len(plans))]


def _analytic(m, k, n):
    return gemm_plan(m, [n], k, True)


# ---------------------------------------------------------------------------
# The table
# ---------------------------------------------------------------------------
def test_autotune_cache_roundtrip(tune_cache, monkeypatch):
    m, k, n = 4, 2048, 2048
    monkeypatch.setenv(dispatch.TUNE_ENV, "full")
    tuned = dispatch.select_plan(m, k, n, out_dtype=torch.float32)
    assert tune_cache.exists() and len(fake_measure.calls) == 1
    plans = fake_measure.calls[0][-1]
    assert plans[0] == _analytic(m, k, n) and tuned == plans[-1]
    assert tuned != _analytic(m, k, n)
    # measured entries are backend-qualified, in the port's plan fields
    entry = json.loads(tune_cache.read_text())[f"{m}x{k}x{n}:float32:cuda"]
    assert GemmPlan(entry["variant"], entry["cols"], entry["split"],
                    entry["chunk"]) == tuned
    assert entry["schedule"] == tuned.schedule
    assert entry["us"] > 0 and entry["analytic_us"] > entry["us"]
    assert entry["backend"] == "cuda" and entry["card"] == "test card, 0 W"
    assert entry["candidates"] == len(plans)
    assert not {"block_m", "block_n", "block_k"} & entry.keys()

    # cached mode returns the measured plan without measuring again
    monkeypatch.setenv(dispatch.TUNE_ENV, "cached")
    dispatch.reset_cache_state()
    assert dispatch.select_plan(m, k, n, out_dtype=torch.float32) == tuned
    assert len(fake_measure.calls) == 1

    # off ignores the table entirely
    monkeypatch.setenv(dispatch.TUNE_ENV, "off")
    assert dispatch.select_plan(m, k, n, out_dtype=torch.float32) == \
        _analytic(m, k, n)


def test_cached_mode_prefers_stored_plan(tune_cache, monkeypatch):
    """A table entry overrides the analytic pick."""
    m, k, n = 4, 2048, 2048
    monkeypatch.setenv(dispatch.TUNE_ENV, "cached")
    stored = GemmPlan("swap", 8, 1, 16)
    assert stored != _analytic(m, k, n)
    tune_cache.write_text(json.dumps({
        f"{m}x{k}x{n}:float32": dict(stored._asdict())}))
    assert dispatch.select_plan(m, k, n, out_dtype=torch.float32) == stored
    # another dtype is another key
    assert dispatch.select_plan(m, k, n, out_dtype=torch.bfloat16) == \
        _analytic(m, k, n)


def test_corrupt_cache_falls_back_to_analytic(tune_cache, monkeypatch):
    monkeypatch.setenv(dispatch.TUNE_ENV, "cached")
    tune_cache.write_text("{not json")
    assert dispatch.select_plan(64, 768, 3072, out_dtype=torch.float32) == \
        _analytic(64, 768, 3072)


@pytest.mark.parametrize("backend", ["tpu", "interpret", "rocm"])
def test_cached_entry_from_other_backend_is_a_miss(tune_cache, monkeypatch,
                                                   backend):
    m, k, n = 4, 2048, 2048
    monkeypatch.setenv(dispatch.TUNE_ENV, "cached")
    tune_cache.write_text(json.dumps({
        f"{m}x{k}x{n}:float32:{backend}": dict(
            GemmPlan("swap", 8, 1, 16)._asdict(), backend=backend)}))
    assert dispatch.select_plan(m, k, n, out_dtype=torch.float32) == \
        _analytic(m, k, n)


def test_entry_without_schedule_is_inferred(tune_cache, monkeypatch):
    """Hand-shipped entries may omit ``schedule``: the split says it."""
    m, k, n = 4, 2048, 2048
    monkeypatch.setenv(dispatch.TUNE_ENV, "cached")
    tune_cache.write_text(json.dumps({
        f"{m}x{k}x{n}:float32": {"variant": "swap", "cols": 8, "split": 8,
                                 "chunk": 2}}))
    plan = dispatch.select_plan(m, k, n, out_dtype=torch.float32)
    assert plan == GemmPlan("swap", 8, 8, 2)
    assert plan.schedule == dispatch.Schedule.K_SPLIT


# entries the kernel would not take at 4 x 2048 x 2048 (16 k-steps), a
# schedule that contradicts the split, and the JAX package's form
REFUSED = [
    {"variant": "swap", "cols": 8, "split": 2, "chunk": 4},     # 8 of 16
    {"variant": "swap", "cols": 8, "split": 4, "chunk": 6},     # empty last
    {"variant": "wide", "cols": 256, "split": 2, "chunk": 8},   # wide split
    {"variant": "swap", "cols": 24, "split": 1, "chunk": 16},   # no width 24
    {"variant": "tile", "cols": 8, "split": 1, "chunk": 16},
    {"variant": "swap", "cols": 8, "split": 4, "chunk": 4,
     "schedule": "panel"},
    {"variant": "swap", "cols": 8, "split": 4},
    {"variant": "swap", "cols": "eight", "split": 4, "chunk": 4},
    {"block_m": 8, "block_n": 512, "block_k": 2048, "schedule": "panel"},
    {"variant": "swap", "cols": 8, "split": 1, "chunk": 16,
     "block_m": 8, "block_n": 128},
]


@pytest.mark.parametrize("entry", REFUSED, ids=range(len(REFUSED)))
def test_entry_check_plan_refuses_is_a_miss(tune_cache, monkeypatch, entry):
    """An entry becomes a plan only if check_plan takes it at the shape
    (the port's counterpart of the JAX package's VMEM check)."""
    m, k, n = 4, 2048, 2048
    monkeypatch.setenv(dispatch.TUNE_ENV, "cached")
    tune_cache.write_text(json.dumps({f"{m}x{k}x{n}:float32": entry}))
    assert dispatch.select_plan(m, k, n, out_dtype=torch.float32) == \
        _analytic(m, k, n)


def test_unaligned_or_ragged_k_takes_general_without_lookup(tune_cache,
                                                            monkeypatch):
    """Operands TMA cannot read stay on the general tile: the key does not
    hold alignment, so a table entry is never read for them."""
    monkeypatch.setenv(dispatch.TUNE_ENV, "full")
    tune_cache.write_text(json.dumps({
        "4x2048x2048:float32": dict(GemmPlan("swap", 8, 1, 16)._asdict()),
        "5x770x100:float32": dict(GemmPlan("swap", 8, 1, 7)._asdict())}))
    general = GemmPlan("general", 0, 1, 0)
    assert dispatch.select_plan(4, 2048, 2048, out_dtype=torch.float32,
                                aligned=False) == general
    assert dispatch.select_plan(5, 770, 100, out_dtype=torch.float32) == \
        general
    assert fake_measure.calls == []


def test_invalid_tune_mode_rejected(monkeypatch):
    monkeypatch.setenv(dispatch.TUNE_ENV, "sometimes")
    with pytest.raises(ValueError):
        dispatch.tune_mode()
    with pytest.raises(ValueError):
        dispatch.select_plan(4, 2048, 2048)


@pytest.mark.parametrize("mode", ["off", "cached", "full", "", "Off",
                                  "sometimes", "FULL"])
def test_tune_mode_accepts_what_jax_accepts(monkeypatch, mode):
    monkeypatch.setenv(dispatch.TUNE_ENV, mode)
    try:
        want = jax_dispatch.tune_mode()
    except ValueError:
        with pytest.raises(ValueError):
            dispatch.tune_mode()
    else:
        assert dispatch.tune_mode() == want


def test_default_cache_is_the_ports_own(monkeypatch):
    monkeypatch.delenv(dispatch.CACHE_ENV, raising=False)
    assert dispatch.cache_path().endswith("repro_torch/gemm_tune.json")
    assert dispatch.cache_path() != jax_dispatch.cache_path()
    assert dispatch.seed_table_path() != jax_dispatch.seed_table_path()


# ---------------------------------------------------------------------------
# Measurement departures: failures raise, the spread keeps the analytic
# ---------------------------------------------------------------------------
def test_failed_measurement_raises_under_full(tune_cache, monkeypatch):
    """The JAX package warns and falls back to the analytic plan; on the
    card that would hide a kernel that fails to launch or to match, so the
    port raises and writes nothing."""
    def broken(*args):
        raise RuntimeError("differs from the plain version")
    monkeypatch.setattr(dispatch, "_measure_all", broken)
    monkeypatch.setenv(dispatch.TUNE_ENV, "full")
    with pytest.raises(RuntimeError, match="plain version"):
        dispatch.select_plan(4, 2048, 2048)
    with pytest.raises(RuntimeError, match="plain version"):
        dispatch.select_fused_plan(4, 2048, 2048, 256)
    assert not tune_cache.exists()


def test_tuning_needs_a_card_here(monkeypatch, tmp_path):
    """Without the fake, measuring needs a CUDA card."""
    monkeypatch.setenv(dispatch.CACHE_ENV, str(tmp_path / "t.json"))
    monkeypatch.setenv(dispatch.SEED_ENV, "0")
    monkeypatch.setenv(dispatch.TUNE_ENV, "full")
    dispatch.reset_cache_state()
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA card"):
        dispatch.select_plan(4, 2048, 2048)


@pytest.mark.parametrize("gain,spread,keeps", [(5.0, 1.0, False),
                                               (1.0, 1.0, True),
                                               (0.5, 2.0, True)])
def test_tuner_keeps_analytic_within_the_spread(tune_cache, monkeypatch,
                                                gain, spread, keeps):
    """A candidate that beats the analytic pick by no more than the
    replays' spread does not enter the table."""
    def measure(plans, *args):
        return [(10.0, spread)] + [(10.0 - gain, 0.0)] * (len(plans) - 1)
    monkeypatch.setattr(dispatch, "_measure_all", measure)
    results = []
    plan = dispatch.tune(4, 2048, 2048, results=results)
    analytic = _analytic(4, 2048, 2048)
    assert (plan == analytic) == keeps
    assert results[0] == (analytic, 10.0) and len(results) > 1
    entry = json.loads(tune_cache.read_text())["4x2048x2048:bfloat16:cuda"]
    assert entry["analytic_us"] == 10.0
    assert entry["us"] == (10.0 if keeps else 10.0 - gain)


# ---------------------------------------------------------------------------
# Candidates and the Hopper model
# ---------------------------------------------------------------------------
@given(st.integers(1, 4096), st.integers(1, 8192), st.integers(1, 8192))
def test_candidates_pass_check_plan_analytic_first(m, k, n):
    plans = dispatch.candidate_plans(m, k, n)
    assert plans and plans[0] == _analytic(m, k, n)
    assert len(plans) == len(set(plans)) <= 8
    for plan in plans:
        check_plan(plan, m, [n], k, True)
        assert PlanModel(plan, m, (n,), k).fits_smem
    if k % 16:
        assert plans == [GemmPlan("general", 0, 1, 0)]


def test_candidates_cover_the_sweeps_plans():
    """The wide plan where M > 64, the swap plan at each split K allows,
    and the swap plan past 512 rows where every width is narrow."""
    plans = dispatch.candidate_plans(256, 3072, 768)
    assert GemmPlan("wide", 256, 1, 24) in plans
    assert {p.split for p in plans if p.variant == "swap"} >= {1, 2, 4, 8}
    narrow = dispatch.candidate_plans(8192, 3584, 64)
    assert narrow[0] == GemmPlan("wide", 256, 1, 28)
    assert GemmPlan("swap", 64, 1, 28) in narrow
    assert all(p.variant == "wide"
               for p in dispatch.candidate_plans(8192, 2048, 2048))


@given(st.integers(1, 2048), st.integers(1, 4096), st.integers(1, 4096))
def test_select_plan_always_feasible(m, k, n):
    plan = dispatch.select_plan(m, k, n, out_dtype=torch.bfloat16)
    check_plan(plan, m, [n], k, True)


@pytest.mark.parametrize("m,ns,k", [(4, (2048,), 2048), (20, (11008,), 2048),
                                    (8192, (2048, 256, 256), 2048),
                                    (4, (64,), 3584), (300, (256,), 4096)])
def test_choose_plan_is_gemm_plan(m, ns, k):
    assert choose_plan(m, ns, k, True) == gemm_plan(m, list(ns), k, True)


def test_plan_model_counts_split_partials_and_kernels():
    """A split K writes and reads back split x M x N int32 partials and
    launches a second kernel; every variant's shared memory fits a
    block."""
    one = PlanModel(GemmPlan("swap", 8, 1, 16), 4, (2048,), 2048)
    four = PlanModel(GemmPlan("swap", 8, 4, 4), 4, (2048,), 2048)
    assert four.hbm_bytes - one.hbm_bytes == 2 * 4 * 4 * 2048 * 4
    assert (one.kernels, four.kernels) == (1, 2)
    assert (one.items, four.items) == (16, 64)
    for variant, cols in [("wide", 256), ("general", 0),
                          *(("swap", c) for c in (8, 16, 32, 64))]:
        assert smem_bytes(variant, cols, 3) <= SMEM_PER_BLOCK
    wide = PlanModel(GemmPlan("wide", 256, 1, 16), 8192, (2048,), 2048)
    assert wide.tiles == 64 * 8 and wide.waves == 4
    assert wide.ops == 2 * 8192 * 2048 * 2048
    half = PlanModel(GemmPlan("wide", 256, 1, 16), 4096, (2048,), 2048)
    assert wide.time_estimate() > half.time_estimate() > 0


# ---------------------------------------------------------------------------
# The wrappers' memo
# ---------------------------------------------------------------------------
def test_plan_for_memoizes_until_the_table_changes(tune_cache, monkeypatch):
    """The wrappers look a shape's plan up once; reset_cache_state (and a
    store) drop the memo; a patched gemm_plan is its own memo key."""
    a = torch.zeros((4, 2048), dtype=torch.int8)
    b = torch.zeros((2048, 2048), dtype=torch.int8)
    monkeypatch.setenv(dispatch.TUNE_ENV, "cached")
    stored = GemmPlan("swap", 8, 1, 16)
    assert matmul_ops.plan_for(4, (2048,), 2048, torch.float32, a, b) == \
        _analytic(4, 2048, 2048)
    tune_cache.write_text(json.dumps({
        "4x2048x2048:float32": dict(stored._asdict())}))
    # still the memo's until the table state is dropped
    assert matmul_ops.plan_for(4, (2048,), 2048, torch.float32, a, b) == \
        _analytic(4, 2048, 2048)
    dispatch.reset_cache_state()
    assert matmul_ops.plan_for(4, (2048,), 2048, torch.float32, a, b) == \
        stored
    forced = GemmPlan("swap", 8, 2, 8)
    monkeypatch.setenv(dispatch.TUNE_ENV, "off")
    monkeypatch.setattr(matmul_ops, "gemm_plan", lambda *args: forced)
    dispatch.reset_cache_state()
    assert matmul_ops.plan_for(4, (2048,), 2048, torch.float32, a, b) == \
        forced
    # a plan check_plan refuses raises at every call
    monkeypatch.setattr(matmul_ops, "gemm_plan",
                        lambda *args: GemmPlan("swap", 8, 2, 1))
    for _ in range(2):
        with pytest.raises(ValueError, match="does not fit"):
            matmul_ops.plan_for(4, (2048,), 2048, torch.float32, a, b)


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", [(64, 768, 3072), (4, 2048, 2048),
                                   (8192, 11008, 2048)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("backend", [None, "cuda", "tpu"])
def test_keys_are_the_jax_packages(m, k, n, dtype, backend):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    assert dispatch._key(m, k, n, tdt, backend) == \
        jax_dispatch._key(m, k, n, jdt, backend)
    assert dispatch._fused_key(m, k, n, n // 8, tdt, backend) == \
        jax_dispatch._fused_key(m, k, n, n // 8, jdt, backend)


def test_one_file_holds_both_packages_entries(tmp_path, monkeypatch):
    """Each package resolves one shared table to its own entries only."""
    path = tmp_path / "shared.json"
    port_plan = GemmPlan("swap", 64, 2, 3)
    path.write_text(json.dumps({
        # the JAX package's entry, unqualified, and the port's, qualified
        "64x768x3072:bfloat16": {"block_m": 64, "block_n": 128,
                                 "block_k": 768, "schedule": "panel"},
        "64x768x3072:bfloat16:cuda": dict(port_plan._asdict(),
                                          schedule="k_split"),
        # the port's entry, unqualified: JAX must not read it
        "64x768x768:bfloat16": dict(port_plan._asdict()),
    }))
    for mod in (dispatch, jax_dispatch):
        monkeypatch.setenv(mod.CACHE_ENV, str(path))
        monkeypatch.setenv(mod.SEED_ENV, "0")
        monkeypatch.setenv(mod.TUNE_ENV, "cached")
        mod.reset_cache_state()
    try:
        assert dispatch.select_plan(64, 3072, 768) == \
            _analytic(64, 3072, 768)
        assert dispatch.select_plan(64, 768, 3072) == port_plan
        assert dispatch.select_plan(64, 768, 768) == port_plan
        jax_plan = jax_dispatch.select_plan(64, 768, 3072,
                                            out_dtype=jnp.bfloat16)
        assert (jax_plan.block_m, jax_plan.block_n) == (64, 128)
        from repro.core.tiling import choose_plan as jax_choose
        want = jax_choose(64, 768, 768)
        got = jax_dispatch.select_plan(64, 768, 768, out_dtype=jnp.bfloat16)
        assert (got.block_m, got.block_n) == (want.block_m, want.block_n)
    finally:
        dispatch.reset_cache_state()
        jax_dispatch.reset_cache_state()
