"""Fused QKV plans (K3) in the port's dispatcher: the extended keys, the
schedules and the shipped table, mirroring ``tests/test_fused_schedule.py``
case for case where a case has meaning in the port.

The measurement is faked as in ``tests/test_torch_dispatch.py``
(``fake_measure``: the i-th of n candidates at 100 - i µs, no spread).
A port schedule is the K split (``Schedule.PANEL``: split 1, one block
walks all of K; ``K_SPLIT``: split > 1 over blocks, int32 partials summed
by a second kernel).
"""
import json
import re

import pytest
import torch

from repro_torch.core import dispatch
from repro_torch.core.dispatch import Schedule
from repro_torch.core.tiling import GemmPlan, PlanModel
from repro_torch.kernels.tiled_matmul.ops import check_plan, gemm_plan
from test_torch_dispatch import fake_measure, tune_cache  # noqa: F401


def _analytic(m, k, nq, nkv):
    return gemm_plan(m, [nq, nkv, nkv], k, True)


def test_fused_tune_cache_roundtrip(tune_cache, monkeypatch):
    """full writes the extended key with a schedule; cached returns the
    identical plan without measuring; off the analytic one."""
    m, k, nq, nkv = 4, 2048, 2048, 256
    monkeypatch.setenv(dispatch.TUNE_ENV, "full")
    tuned = dispatch.select_fused_plan(m, k, nq, nkv,
                                       out_dtype=torch.float32)
    assert fake_measure.calls[0][1] == (nq, nkv, nkv)
    entry = json.loads(tune_cache.read_text())[
        f"{m}x{k}x{nq}+{nkv}:float32:cuda"]
    assert entry["schedule"] in ("panel", "k_split")
    assert entry["schedule"] == tuned.schedule
    assert entry["us"] > 0

    monkeypatch.setenv(dispatch.TUNE_ENV, "cached")
    dispatch.reset_cache_state()
    assert dispatch.select_fused_plan(m, k, nq, nkv,
                                      out_dtype=torch.float32) == tuned
    assert len(fake_measure.calls) == 1

    monkeypatch.setenv(dispatch.TUNE_ENV, "off")
    assert dispatch.select_fused_plan(m, k, nq, nkv, out_dtype=torch.float32) \
        == _analytic(m, k, nq, nkv)


def test_fused_key_distinguishes_nq_nkv_split(tune_cache, monkeypatch):
    """Same total width, another (Nq, Nkv) split: another key, so a GQA
    entry never serves the MHA shape."""
    m, k = 32, 128
    monkeypatch.setenv(dispatch.TUNE_ENV, "cached")
    stored = GemmPlan("swap", 64, 1, 1)
    assert stored != _analytic(m, k, 256, 64)
    tune_cache.write_text(json.dumps({
        f"{m}x{k}x256+64:float32": dict(stored._asdict(),
                                        schedule="panel")}))
    assert dispatch.select_fused_plan(m, k, 256, 64,
                                      out_dtype=torch.float32) == stored
    assert dispatch.select_fused_plan(m, k, 192, 96,
                                      out_dtype=torch.float32) == \
        _analytic(m, k, 192, 96)


@pytest.mark.parametrize("split,chunk,schedule",
                         [(1, 16, Schedule.PANEL), (8, 2, Schedule.K_SPLIT)])
def test_legacy_single_gemm_key_fallback(tune_cache, monkeypatch, split,
                                         chunk, schedule):
    """A single-GEMM MxKxNq entry serves the fused shape where no fused key
    matches: its split 1 / > 1 is the panel / k_split schedule."""
    m, k, nq, nkv = 4, 2048, 2048, 256
    monkeypatch.setenv(dispatch.TUNE_ENV, "cached")
    tune_cache.write_text(json.dumps({
        f"{m}x{k}x{nq}:float32": {"variant": "swap", "cols": 8,
                                  "split": split, "chunk": chunk}}))
    plan = dispatch.select_fused_plan(m, k, nq, nkv, out_dtype=torch.float32)
    assert plan == GemmPlan("swap", 8, split, chunk)
    assert plan.schedule == schedule
    assert dispatch.plan_schedule(plan) is schedule


def test_fused_entry_without_schedule_inferred(tune_cache, monkeypatch):
    m, k, nq, nkv = 32, 512, 64, 64
    monkeypatch.setenv(dispatch.TUNE_ENV, "cached")
    tune_cache.write_text(json.dumps({
        f"{m}x{k}x{nq}+{nkv}:float32": {"variant": "swap", "cols": 32,
                                         "split": 2, "chunk": 2}}))
    plan = dispatch.select_fused_plan(m, k, nq, nkv, out_dtype=torch.float32)
    assert plan.schedule == Schedule.K_SPLIT and plan.split == 2


def test_fused_entry_check_plan_refuses_rejected(tune_cache, monkeypatch):
    """Fused entries are held to check_plan at the fused shape: a split
    that misses k-steps falls back to the analytic plan."""
    m, k, nq, nkv = 4, 2048, 2048, 256
    monkeypatch.setenv(dispatch.TUNE_ENV, "cached")
    tune_cache.write_text(json.dumps({
        f"{m}x{k}x{nq}+{nkv}:float32": {"variant": "swap", "cols": 8,
                                         "split": 2, "chunk": 4,
                                         "schedule": "k_split"}}))
    assert dispatch.select_fused_plan(m, k, nq, nkv,
                                      out_dtype=torch.float32) == \
        _analytic(m, k, nq, nkv)


def test_fused_candidates_cover_both_schedules():
    """Where K allows, the tuner races both schedules."""
    plans = dispatch.fused_candidate_plans(48, 2048, 256, 64)
    assert {p.schedule for p in plans} == {Schedule.PANEL, Schedule.K_SPLIT}
    assert plans[0] == _analytic(48, 2048, 256, 64)
    for p in plans:
        check_plan(p, 48, [256, 64, 64], 2048, True)
        assert PlanModel(p, 48, (256, 64, 64), 2048).fits_smem


# ---------------------------------------------------------------------------
# The shipped table
# ---------------------------------------------------------------------------
PAPER_KEYS = [f"{shape}:{dt}" for shape in (
    "64x768x768", "64x768x3072", "64x3072x768", "64x768x768+768")
    for dt in ("bfloat16", "float32")]
KEY = re.compile(r"^(\d+)x(\d+)x(\d+)(?:\+(\d+))?:(bfloat16|float32)$")


def _shipped():
    with open(dispatch.seed_table_path()) as f:
        return json.load(f)


def test_shipped_table_entries_pass_check_plan():
    """Every shipped entry is unqualified, in the port's plan fields, takes
    check_plan at its shape, and carries its measurement and card."""
    table = _shipped()
    assert set(PAPER_KEYS) <= table.keys()
    for key, entry in table.items():
        m, k, n, nkv, _ = KEY.match(key).groups()
        m, k, n = int(m), int(k), int(n)
        ns = [n] if nkv is None else [n, int(nkv), int(nkv)]
        plan = GemmPlan(entry["variant"], entry["cols"], entry["split"],
                        entry["chunk"])
        check_plan(plan, m, ns, k, True)
        assert entry["schedule"] == plan.schedule
        assert entry["us"] > 0 and entry["analytic_us"] > 0
        assert "H100" in entry["card"] and entry["backend"] == "cuda"
        assert not {"block_m", "block_n", "block_k"} & entry.keys()


def test_seed_table_covers_paper_shapes(tmp_path, monkeypatch):
    """With no user table the shipped one serves the paper shapes, the
    fused 64-row DistilBERT panel included."""
    monkeypatch.setenv(dispatch.CACHE_ENV, str(tmp_path / "nonexistent.json"))
    monkeypatch.delenv(dispatch.SEED_ENV, raising=False)
    monkeypatch.setenv(dispatch.TUNE_ENV, "cached")
    dispatch.reset_cache_state()
    try:
        seed = _shipped()
        entry = seed["64x768x3072:bfloat16"]
        assert dispatch.select_plan(64, 768, 3072) == GemmPlan(
            entry["variant"], entry["cols"], entry["split"], entry["chunk"])
        fentry = seed["64x768x768+768:bfloat16"]
        fused = dispatch.select_fused_plan(64, 768, 768, 768)
        assert fused == GemmPlan(fentry["variant"], fentry["cols"],
                                 fentry["split"], fentry["chunk"])
        assert fused.schedule == fentry["schedule"]
    finally:
        dispatch.reset_cache_state()


def test_seed_table_disabled_by_env(tmp_path, monkeypatch):
    monkeypatch.setenv(dispatch.CACHE_ENV, str(tmp_path / "nonexistent.json"))
    monkeypatch.setenv(dispatch.SEED_ENV, "0")
    dispatch.reset_cache_state()
    try:
        assert dispatch.load_cache() == {}
    finally:
        dispatch.reset_cache_state()


def test_user_cache_overrides_seed(tmp_path, monkeypatch):
    path = tmp_path / "user.json"
    mine = GemmPlan("swap", 64, 3, 2)
    assert _shipped()["64x768x3072:bfloat16"]["split"] != 3
    path.write_text(json.dumps({"64x768x3072:bfloat16": dict(
        mine._asdict(), schedule="k_split")}))
    monkeypatch.setenv(dispatch.CACHE_ENV, str(path))
    monkeypatch.delenv(dispatch.SEED_ENV, raising=False)
    monkeypatch.setenv(dispatch.TUNE_ENV, "cached")
    dispatch.reset_cache_state()
    try:
        assert dispatch.select_plan(64, 768, 3072) == mine
    finally:
        dispatch.reset_cache_state()


def test_store_does_not_persist_seed_entries(tune_cache, monkeypatch):
    """Tuning writes only the user's entries; lookups see both."""
    monkeypatch.delenv(dispatch.SEED_ENV, raising=False)
    dispatch.reset_cache_state()
    dispatch._store("1x32x3:float32", {"variant": "swap", "cols": 8,
                                       "split": 1, "chunk": 1})
    on_disk = json.loads(tune_cache.read_text())
    assert list(on_disk) == ["1x32x3:float32"]
    table = dispatch.load_cache()
    assert "1x32x3:float32" in table and "64x768x3072:bfloat16" in table
