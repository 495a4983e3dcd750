"""The port's CUDA kernels against their plain versions, on the card.

Run on a machine with an H100:  python -m pytest -m gpu tests/test_torch_gpu.py
Without a card every test here skips (the card is checked in a fixture).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import dispatch
from repro_torch.core.quantization import quantize, quantize_kv
from repro_torch.core.quantized_linear import quantize_weight
from repro_torch.kernels import (launch_counts, plan_counts,
                                 reset_launch_counts)
from repro_torch.kernels.flash_attention import ref as paged_ref
from repro_torch.kernels.flash_attention.decode import (flash_decode_schedule,
                                                        split_plan)
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     paged_decode_attention)
from repro_torch.kernels.fused_qkv import ref as fused_ref
from repro_torch.kernels.fused_qkv.ops import fused_qkv
from repro_torch.kernels.quant_act import ops as quant_ops
from repro_torch.kernels.quant_act import ref as quant_ref
from repro_torch.kernels.quant_act.ops import (QuantPlan, candidate_plans,
                                               quant_act, quant_act_glu)
from repro_torch.kernels.tiled_matmul import ref as matmul_ref
from repro_torch.kernels import _build
from repro_torch.kernels.tiled_matmul import ops as matmul_ops
from repro_torch.kernels.tiled_matmul.ops import (GemmPlan, gemm_plan,
                                                  tiled_matmul)
from repro_torch.models.transformer import apply_model, init_model
from repro_torch.serving.cache import default_page_table

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def tune_off(monkeypatch):
    """Plans from gemm_plan alone (REPRO_TUNE=off): a test that asserts or
    forces gemm_plan's plan must not get the shipped table's instead."""
    monkeypatch.setenv(dispatch.TUNE_ENV, "off")
    dispatch.reset_cache_state()
    yield
    dispatch.reset_cache_state()


def _randn(shape, seed, dev, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dev)


def _row_rel_err(got, want):
    """chip_smoke.py's rule for bf16 attention outputs: the worst row's
    max |got - want| over that row's own max |want| (a row being one head
    of one query); a row the masks leave empty (want 0) must be 0."""
    diff = (got.double() - want.double()).abs().amax(-1)
    size = want.double().abs().amax(-1)
    ratio = torch.where(size > 0, diff / size.clamp_min(1e-300),
                        torch.where(diff > 0, float("inf"), 0.0))
    return ratio.max().item()


def _grad_row_rel_err(got, want):
    """The bf16 rule for K5's gradients: ``_row_rel_err`` where each row is
    held against its largest |value| or, where that lies below bf16's
    resolution of the whole tensor (2^-8 of its largest |value|), against
    that resolution: a row whose exact gradient cancels to ~0 (the first
    query of a causal row sees one key, and dS = P (dP - D) = 0) is
    rounding noise on both sides."""
    floor = want.double().abs().max() * 2.0 ** -8
    diff = (got.double() - want.double()).abs().amax(-1)
    size = want.double().abs().amax(-1).clamp_min(floor)
    return (diff / size).max().item()


def _operands(m, k, ns, dev, seed=0):
    """Per-row quantized A and per-channel quantized, K-major weights."""
    a = quantize(_randn((m, k), seed, dev), channel_axes=(0,))
    ws = [quantize_weight(_randn((k, n), seed + 1 + i, dev, 0.05))
          for i, n in enumerate(ns)]
    return a, ws


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(256, 768), (256, 3072), (5, 770)])
def test_quant_act_kernel_bitwise(cuda, shape, dtype):
    x = _randn(shape, 1, cuda, 3.0).to(dtype)
    x[0] = 0
    q = quant_act(x)
    torch.cuda.synchronize()
    v, s = quant_ref.quant_act_ref(x)
    assert torch.equal(q.values, v) and torch.equal(q.scale, s)


def _rows(shape, seed, dev, dtype):
    """Rows of normal values, one of them zero, one with a single huge
    value (its other values quantize to 0), one on a tiny scale."""
    x = _randn(shape, seed, dev, 3.0)
    x[0] = 0
    if shape[0] > 2:
        x[1, shape[1] // 3] = 3e4
        x[2] *= 1e-3
    return x.to(dtype)


# the shapes K1 meets on the served paths (distilbert, qwen2.5-3b at decode,
# verify and prefill, gemma2-27b's d_ff), ragged ones, a row of 64
QUANT_SHAPES = [(256, 768), (4, 3072), (4, 2048), (20, 11008),
                (8192, 2048), (1024, 11008), (4, 36864), (300, 36864),
                (5, 770), (129, 11008), (3, 64), (133, 1000)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", QUANT_SHAPES,
                         ids=[f"{m}x{k}" for m, k in QUANT_SHAPES])
def test_quant_act_every_plan_bitwise(cuda, shape, dtype, monkeypatch):
    """Every row mapping that takes the shapes (one block a row, clusters
    of 2, 4, 8 and quant_plan's own) is bitwise the plain version."""
    x = _rows(shape, shape[1], cuda, dtype)
    v, s = quant_ref.quant_act_ref(x)
    plans = candidate_plans(*shape, dtype, True)
    assert quant_ops.quant_plan(*shape, dtype, True) in plans
    for plan in plans:
        monkeypatch.setattr(quant_ops, "quant_plan", lambda *args: plan)
        q = quant_act(x)
        torch.cuda.synchronize()
        assert torch.equal(q.values, v) and torch.equal(q.scale, s), plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 11008), (20, 11008), (1024, 11008),
                                   (5, 770), (129, 11008), (3, 64)])
def test_quant_act_glu_every_plan_bitwise(cuda, shape, dtype, monkeypatch):
    """quant_act_glu in every mapping is bitwise quant_act of
    F.silu(gate) * up, and its h is that product."""
    g = _rows(shape, 1, cuda, dtype)
    u = _randn(shape, 2, cuda).to(dtype)
    v, s = quant_ref.quant_act_glu_ref(g, u)
    want_h = torch.nn.functional.silu(g) * u
    for plan in candidate_plans(*shape, dtype, True):
        monkeypatch.setattr(quant_ops, "quant_plan", lambda *args: plan)
        h = torch.full_like(g, float("nan"))
        q = quant_act_glu(g, u, h_out=h)
        q2 = quant_act_glu(g, u)
        torch.cuda.synchronize()
        assert torch.equal(q.values, v) and torch.equal(q.scale, s), plan
        assert torch.equal(q2.values, v) and torch.equal(q2.scale, s), plan
        assert torch.equal(h, want_h), plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_act_glu_h_over_every_bf16_gate(cuda, dtype):
    """h = silu(g) * u bitwise PyTorch's, for g every finite bf16 value
    (as f32 too), u = 1 and u drawn from a seed."""
    bits = torch.arange(0, 2 ** 16, dtype=torch.int32).to(torch.int16)
    g = bits.view(torch.bfloat16)
    g = g[torch.isfinite(g)]
    g = torch.cat([g, g.new_zeros(-len(g) % 1024)]).reshape(-1, 1024)
    g = g.to(cuda).to(dtype)
    for u in (torch.ones_like(g), _randn(tuple(g.shape), 5, cuda).to(dtype)):
        h = torch.empty_like(g)
        q = quant_act_glu(g, u, h_out=h)
        torch.cuda.synchronize()
        assert torch.equal(h, torch.nn.functional.silu(g) * u)
    # with u = 1 no product overflows, so the rows quantize as the plain
    # version does (a row holding inf has no finite scale to match)
    v, s = quant_ref.quant_act_glu_ref(g, torch.ones_like(g))
    q = quant_act_glu(g, torch.ones_like(g))
    assert torch.equal(q.values, v) and torch.equal(q.scale, s)


def test_quant_act_unaligned_base_takes_the_scalar_access(cuda):
    """A base off 16 bytes plans onto one value an access, bitwise."""
    base = _randn((8 * 2048 + 3,), 3, cuda).to(torch.bfloat16)
    y = base[3:].view(8, 2048)                # 6 bytes past the allocation
    assert y.data_ptr() % 16 != 0
    assert quant_ops.quant_plan(8, 2048, torch.bfloat16, False).vec == 1
    q = quant_act(y)
    v, s = quant_ref.quant_act_ref(y)
    assert torch.equal(q.values, v) and torch.equal(q.scale, s)


# plans the wrappers refuse at x (4, 2048) bf16: a slice left empty, a
# share too large for the registers, too many blocks, a block row split,
# vector accesses on an unaligned K
QUANT_MISFITS = [QuantPlan("cluster", 8, 32, 8, 1)._replace(per=0),
                 QuantPlan("block", 8, 32, 1, 4),
                 QuantPlan("block", 8, 32, 1, 9),
                 QuantPlan("cluster", 8, 32, 9, 1),
                 QuantPlan("block", 8, 32, 2, 8),
                 QuantPlan("block", 8, 48, 1, 8),
                 QuantPlan("cluster", 8, 32, 1, 8)]


@pytest.mark.parametrize("plan", QUANT_MISFITS, ids=str)
def test_quant_wrappers_refuse_plans_that_do_not_fit(cuda, plan, monkeypatch):
    x = _randn((4, 2048), 0, cuda).to(torch.bfloat16)
    monkeypatch.setattr(quant_ops, "quant_plan", lambda *args: plan)
    with pytest.raises(ValueError, match="does not fit"):
        quant_act(x)
    with pytest.raises(ValueError, match="does not fit"):
        quant_act_glu(x, x)


# (vec, rows, threads, split, per) the launcher refuses at (4, 2048) bf16
# (rows: 0 one block a row, 1 a cluster, 2 no mapping)
QUANT_LAUNCHER_MISFITS = [(8, 0, 32, 1, 4), (8, 0, 32, 1, 9), (8, 1, 32, 9, 1),
                          (8, 0, 32, 2, 8), (8, 0, 48, 1, 8), (8, 1, 32, 1, 8),
                          (4, 0, 64, 1, 8), (8, 0, 1024, 1, 1),
                          (8, 2, 64, 1, 4)]


@pytest.mark.parametrize("plan", QUANT_LAUNCHER_MISFITS,
                         ids=["-".join(map(str, p))
                              for p in QUANT_LAUNCHER_MISFITS])
def test_quant_launcher_refuses_plans_that_do_not_fit(cuda, plan):
    """The C launcher checks the plan against its own geometry, whatever
    the wrapper sends; a scale it never wrote stays NaN."""
    x = _randn((4, 2048), 0, cuda).to(torch.bfloat16)
    q = torch.zeros((4, 2048), dtype=torch.int8, device=cuda)
    s = torch.full((4, 1), float("nan"), device=cuda)
    rc = _build.library("quant_act").launch_quant_act(
        x.data_ptr(), None, q.data_ptr(), s.data_ptr(), None, None, 4, 2048,
        127, 1, 0, *plan, 0, cuda.index,
        torch.cuda.current_stream(cuda).cuda_stream)
    torch.cuda.synchronize()
    assert rc != 0
    assert torch.isnan(s).all() and not q.any()


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("m,k,n", [(64, 768, 3072), (256, 3072, 768),
                                   (4, 768, 768), (5, 770, 100)])
def test_tiled_matmul_kernel_bitwise(cuda, m, k, n, bias, out_dtype):
    a, (b,) = _operands(m, k, [n], cuda)
    bi = _randn((n,), 9, cuda) if bias else None
    out = tiled_matmul(a, b, bi, out_dtype=out_dtype)
    torch.cuda.synchronize()
    ref = matmul_ref.tiled_matmul_ref(a.values, a.scale, b.values, b.scale,
                                      bi, out_dtype)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("m,k,nq,nkv", [(256, 768, 768, 768),
                                        (64, 2048, 2048, 256),
                                        (4, 768, 768, 768), (3, 70, 50, 20)])
def test_fused_qkv_kernel_bitwise(cuda, m, k, nq, nkv):
    a, ws = _operands(m, k, [nq, nkv, nkv], cuda)
    outs = fused_qkv(a, *ws, out_dtype=torch.float32)
    torch.cuda.synchronize()
    refs = fused_ref.fused_qkv_ref(a.values, a.scale, ws[0].values,
                                   ws[0].scale, ws[1].values, ws[1].scale,
                                   ws[2].values, ws[2].scale,
                                   out_dtype=torch.float32)
    for o, r in zip(outs, refs):
        assert torch.equal(o, r)


# m, k, n and the plan each must take: every variant, split K on both
# tensor-core forms, ragged M / N / K, qwen2.5-3b's served shapes
GEMM_VARIANTS = [
    ((4, 2048, 2048), ("swap", 8, 4)),        # decode wo: split K
    ((4, 11008, 2048), ("swap", 8, 8)),       # decode down
    ((20, 2048, 11008), ("swap", 32, 1)),     # verify gate / up
    ((5, 208, 300), ("swap", 8, 1)),          # ragged N and K
    ((64, 768, 768), ("swap", 64, 1)),
    ((129, 2048, 2048), ("swap", 64, 1)),     # ragged M: three row tiles
    ((192, 2048, 11008), ("wide", 256, 1)),   # wide tiles fill half the SMs
    ((256, 3072, 768), ("swap", 64, 5)),      # distilbert down
    ((300, 160, 600), ("swap", 64, 1)),       # ragged everything
    ((300, 4096, 256), ("swap", 64, 8)),      # five row tiles, split K
    ((513, 208, 300), ("wide", 256, 1)),      # ragged everything
    ((1024, 2048, 11008), ("wide", 256, 1)),
    ((5, 770, 100), ("general", 0, 1)),       # K % 16: no TMA
    # zamba2-7b's narrowest outputs (in_B / in_C 64, in_dt 112) at decode,
    # verify and a long prompt: fewer columns than one weight tile
    ((4, 3584, 64), ("swap", 8, 7)),
    ((20, 3584, 112), ("swap", 32, 7)),
    ((8192, 3584, 64), ("wide", 256, 1)),
    ((8192, 3584, 112), ("wide", 256, 1)),
]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("shape,plan", GEMM_VARIANTS,
                         ids=[f"{v[0]}-{m}x{k}x{n}"
                              for (m, k, n), v in GEMM_VARIANTS])
def test_tiled_matmul_variants_bitwise(cuda, tune_off, shape, plan, bias,
                                       out_dtype):
    m, k, n = shape
    full_plan = gemm_plan(m, [n], k, True)
    assert full_plan[:3] == plan
    a, (b,) = _operands(m, k, [n], cuda, seed=m + n)
    bi = _randn((n,), 9, cuda) if bias else None
    before = dict(tiled_matmul.plans)
    launched = tiled_matmul.launched_plans[full_plan]
    out = tiled_matmul(a, b, bi, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert tiled_matmul.plans[plan[0]] == before.get(plan[0], 0) + 1
    assert tiled_matmul.launched_plans[full_plan] == launched + 1
    ref = matmul_ref.tiled_matmul_ref(a.values, a.scale, b.values, b.scale,
                                      bi, out_dtype)
    assert torch.equal(out, ref)


# m, k, nq, nkv and the plan: qwen2.5-3b's GQA projection at decode,
# verify, a ragged prefill chunk and a long prompt; MHA; ragged widths on
# the wide variant; the general tile
QKV_VARIANTS = [
    ((4, 2048, 2048, 256), ("swap", 8, 4)),
    ((20, 2048, 2048, 256), ("swap", 32, 4)),
    ((129, 2048, 2048, 256), ("swap", 64, 1)),
    ((2048, 2048, 2048, 256), ("wide", 256, 1)),
    ((256, 768, 768, 768), ("swap", 64, 1)),
    ((600, 2048, 520, 136), ("wide", 256, 1)),    # ragged N
    ((3, 70, 50, 20), ("general", 0, 1)),
    ((4, 3584, 3584, 3584), ("swap", 8, 1)),      # zamba2-7b's MHA
]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,plan", QKV_VARIANTS,
                         ids=[f"{v[0]}-{m}x{k}x{nq}-{nkv}"
                              for (m, k, nq, nkv), v in QKV_VARIANTS])
def test_fused_qkv_variants_bitwise(cuda, tune_off, shape, plan, out_dtype):
    m, k, nq, nkv = shape
    full_plan = gemm_plan(m, [nq, nkv, nkv], k, True)
    assert full_plan[:3] == plan
    a, ws = _operands(m, k, [nq, nkv, nkv], cuda, seed=m + nq)
    launched = fused_qkv.launched_plans[full_plan]
    outs = fused_qkv(a, *ws, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert fused_qkv.launched_plans[full_plan] == launched + 1
    refs = fused_ref.fused_qkv_ref(a.values, a.scale, ws[0].values,
                                   ws[0].scale, ws[1].values, ws[1].scale,
                                   ws[2].values, ws[2].scale,
                                   out_dtype=out_dtype)
    for o, r in zip(outs, refs):
        assert torch.equal(o, r)


# every variant, forced at one shape (M = 40, K = 2048, ragged widths)
FORCED_PLANS = [GemmPlan("general", 0, 1, 0), GemmPlan("wide", 256, 1, 16),
                GemmPlan("swap", 64, 1, 16), GemmPlan("swap", 64, 4, 4),
                GemmPlan("swap", 32, 3, 6), GemmPlan("swap", 16, 1, 16),
                GemmPlan("swap", 8, 16, 1)]


@pytest.mark.parametrize("plan", FORCED_PLANS,
                         ids=[f"{p.variant}{p.cols}-split{p.split}"
                              for p in FORCED_PLANS])
def test_every_variant_is_the_plain_version(cuda, tune_off, plan,
                                            monkeypatch):
    """Every variant and split, also where gemm_plan would not take it
    (more row tiles than one, a wide tile of 40 live rows), is bitwise the
    plain version; each wrapper launched the forced plan."""
    a, ws = _operands(40, 2048, [520, 136, 136], cuda, seed=3)
    bias = _randn((520,), 4, cuda)
    monkeypatch.setattr(matmul_ops, "gemm_plan", lambda *args: plan)
    reset_launch_counts()
    out = tiled_matmul(a, ws[0], bias, out_dtype=torch.float32)
    outs = fused_qkv(a, *ws, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert dict(tiled_matmul.launched_plans) == {plan: 1}
    assert dict(fused_qkv.launched_plans) == {plan: 1}
    reset_launch_counts()
    assert torch.equal(out, matmul_ref.tiled_matmul_ref(
        a.values, a.scale, ws[0].values, ws[0].scale, bias, torch.float32))
    refs = fused_ref.fused_qkv_ref(a.values, a.scale, ws[0].values,
                                   ws[0].scale, ws[1].values, ws[1].scale,
                                   ws[2].values, ws[2].scale,
                                   out_dtype=torch.bfloat16)
    for o, r in zip(outs, refs):
        assert torch.equal(o, r)


def test_gemm_kernels_are_deterministic(cuda):
    """Split K sums int32 partials: the same call twice, bit for bit."""
    a, ws = _operands(4, 11008, [2048, 256, 256], cuda)
    assert torch.equal(tiled_matmul(a, ws[0]), tiled_matmul(a, ws[0]))
    for x, y in zip(fused_qkv(a, *ws), fused_qkv(a, *ws)):
        assert torch.equal(x, y)


def test_gemm_wrappers_raise_on_row_major_weights(cuda):
    """The kernels read weights K-major; a row-major B is refused, never
    transposed on the way."""
    a, ws = _operands(8, 64, [64, 32, 32], cuda)
    row_major = [dataclasses.replace(w, values=w.values.contiguous())
                 for w in ws]
    with pytest.raises(ValueError, match="K-major"):
        tiled_matmul(a, row_major[0])
    for i in range(3):
        args = list(ws)
        args[i] = row_major[i]
        with pytest.raises(ValueError, match="K-major"):
            fused_qkv(a, *args)


def test_gemm_wrappers_raise_on_shapes_no_variant_takes(cuda, tune_off,
                                                       monkeypatch):
    """Past K = 133,143 an int32 sum of int8 products may overflow; a plan
    that does not fit the shapes (the wide variant split, splits that miss
    k-steps, TMA over K % 16 != 0) raises before launch."""
    a, (b,) = _operands(1, 133_248, [16], cuda)
    with pytest.raises(ValueError, match="overflow"):
        tiled_matmul(a, b)
    with pytest.raises(ValueError, match="overflow"):
        fused_qkv(a, b, b, b)
    for shape, plan in (((300, 2048, 256), GemmPlan("wide", 256, 2, 8)),
                        ((300, 2048, 256), GemmPlan("wide", 256, 1, 4)),
                        ((4, 2048, 256), GemmPlan("swap", 8, 2, 1)),
                        ((4, 2048, 256), GemmPlan("swap", 8, 1, 0)),
                        ((5, 770, 100), GemmPlan("swap", 8, 1, 7))):
        m, k, n = shape
        a, ws = _operands(m, k, [n, n, n], cuda)
        monkeypatch.setattr(matmul_ops, "gemm_plan", lambda *args: plan)
        with pytest.raises(ValueError, match="does not fit"):
            tiled_matmul(a, ws[0])
        with pytest.raises(ValueError, match="does not fit"):
            fused_qkv(a, *ws)


def test_tune_then_cached_round_trip(cuda, tmp_path, monkeypatch):
    """REPRO_TUNE=full into a fresh table (the shipped one off) measures
    K2 / K3 on the card and stores the winners; under cached the wrappers
    select and launch the stored plans, bitwise the plain version and the
    analytic plan's output; the tuner's own launches do not count."""
    monkeypatch.setenv(dispatch.CACHE_ENV, str(tmp_path / "tune.json"))
    monkeypatch.setenv(dispatch.SEED_ENV, "0")
    monkeypatch.setenv(dispatch.ITERS_ENV, "2")
    a, ws = _operands(4, 2048, [2048, 256, 256], cuda, seed=5)
    stored = {}
    for mode in ("full", "cached"):
        monkeypatch.setenv(dispatch.TUNE_ENV, mode)
        dispatch.reset_cache_state()
        reset_launch_counts()
        # K3 first: its lookup falls back to K2's single-GEMM key
        outs = fused_qkv(a, *ws)
        out = tiled_matmul(a, ws[0])
        torch.cuda.synchronize()
        assert launch_counts()["tiled_matmul"] == 1
        assert launch_counts()["fused_qkv"] == 1
        got = (dict(tiled_matmul.launched_plans),
               dict(fused_qkv.launched_plans))
        stored.setdefault("plans", got)
        assert got == stored["plans"]
        assert torch.equal(out, matmul_ref.tiled_matmul_ref(
            a.values, a.scale, ws[0].values, ws[0].scale, None,
            torch.bfloat16))
        assert torch.equal(out, tiled_matmul(
            a, ws[0], plan=gemm_plan(4, [2048], 2048, True)))
        refs = fused_ref.fused_qkv_ref(a.values, a.scale, ws[0].values,
                                       ws[0].scale, ws[1].values,
                                       ws[1].scale, ws[2].values,
                                       ws[2].scale, out_dtype=torch.bfloat16)
        for o, r in zip(outs, refs):
            assert torch.equal(o, r)
    table = dispatch.load_cache()
    for key, launched in (("4x2048x2048:bfloat16:cuda", got[0]),
                          ("4x2048x2048+256:bfloat16:cuda", got[1])):
        entry = table[key]
        plan = GemmPlan(entry["variant"], entry["cols"], entry["split"],
                        entry["chunk"])
        assert launched == {plan: 1}
        assert entry["us"] > 0 and entry["analytic_us"] > 0
        assert entry["us"] <= entry["analytic_us"]
    reset_launch_counts()
    dispatch.reset_cache_state()


def test_tuning_during_graph_capture_raises(cuda, tmp_path, monkeypatch):
    """A table miss under REPRO_TUNE=full inside CUDA graph capture raises
    (the tuner launches and synchronizes); no plan is stored."""
    monkeypatch.setenv(dispatch.CACHE_ENV, str(tmp_path / "tune.json"))
    monkeypatch.setenv(dispatch.SEED_ENV, "0")
    monkeypatch.setenv(dispatch.TUNE_ENV, "full")
    dispatch.reset_cache_state()
    a, (b,) = _operands(12, 1024, [384], cuda, seed=6)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(graph):
            tiled_matmul(a, b)
    assert not (tmp_path / "tune.json").exists()
    dispatch.reset_cache_state()


# (variant, cols, split, chunk) the launcher refuses at M = 4, K = 2048
# (16 k-steps), N = 256: each would otherwise return a partial product
LAUNCHER_MISFITS = [(1, 256, 1, 4), (1, 256, 2, 8), (2, 8, 2, 1),
                    (2, 8, 1, 0), (2, 8, 4, 6), (2, 24, 1, 16),
                    (2, 8, 2, 8), (3, 8, 1, 16), (0, 0, 2, 8)]


@pytest.mark.parametrize("plan", LAUNCHER_MISFITS,
                         ids=["-".join(map(str, p)) for p in LAUNCHER_MISFITS])
def test_gemm_launcher_refuses_plans_that_do_not_fit(cuda, plan):
    """The C launcher checks the plan against its own geometry, whatever
    the wrapper sends: (2, 8, 2, 8) is a valid split with no scratch."""
    a, (b,) = _operands(4, 2048, [256], cuda)
    out = torch.zeros((4, 256), dtype=torch.float32, device=cuda)
    ws = None if plan == (2, 8, 2, 8) else torch.zeros(
        (16, 4, 256), dtype=torch.int32, device=cuda)
    sa, sb = matmul_ops.row_scale(a), matmul_ops.col_scale(b)
    rc = _build.library("int8_gemm").launch_tiled_matmul(
        a.values.data_ptr(), sa.data_ptr(), b.values.data_ptr(),
        sb.data_ptr(), None, out.data_ptr(),
        ws.data_ptr() if ws is not None else None, 4, 2048, 256, 0, *plan,
        cuda.index, torch.cuda.current_stream(cuda).cuda_stream)
    torch.cuda.synchronize()
    assert rc != 0
    assert not out.any()


def test_cuda_tensors_never_take_the_plain_version(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(quant_ref, "quant_act_ref", refuse)
    monkeypatch.setattr(quant_ref, "quant_act_glu_ref", refuse)
    monkeypatch.setattr(matmul_ref, "tiled_matmul_ref", refuse)
    monkeypatch.setattr(fused_ref, "fused_qkv_ref", refuse)
    monkeypatch.setattr(paged_ref, "paged_decode_attention_ref", refuse)
    monkeypatch.setattr(paged_ref, "attention_ref", refuse)
    reset_launch_counts()
    a = quant_act(_randn((8, 64), 0, cuda))
    quant_act_glu(*(_randn((8, 64), i, cuda) for i in (1, 2)))
    _, ws = _operands(8, 64, [64, 32, 32], cuda)
    tiled_matmul(a, ws[0])
    fused_qkv(a, *ws)
    c = _paged_case(2, 32, 4, 2, 64, 8, [20, 9], cuda)
    paged_decode_attention(c["q"], c["k"], c["v"], c["table"], c["lens"])
    paged_decode_attention(c["q"], c["k"], c["v"], c["table"], c["lens"],
                           new_lens=torch.ones_like(c["lens"]))
    flash_attention(*_flash_case(1, 70, 70, 4, 2, 64, cuda))
    torch.cuda.synchronize()
    assert launch_counts() == {"quant_act": 1, "quant_act_glu": 1,
                               "row_absmax": 0, "tiled_matmul_int32": 0,
                               "int8_epilogue": 0, "fused_qkv": 1,
                               "tiled_matmul": 1, "paged_decode": 1,
                               "paged_decode_verify": 1,
                               "flash_attention": 1,
                               "flash_attention_backward": 0}
    assert {name: sum(by.values()) for name, by in plan_counts().items()} \
        == {"quant_act": 1, "quant_act_glu": 1, "tiled_matmul": 1,
            "fused_qkv": 1}


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    with pytest.raises(TypeError):
        quant_act(_randn((4, 8), 0, cuda).half())
    with pytest.raises(ValueError):
        quant_act(_randn((8, 4), 0, cuda).t())          # not contiguous
    a, (b,) = _operands(4, 32, [16], cuda)
    with pytest.raises(TypeError):
        tiled_matmul(a, b, out_dtype=torch.float16)
    c = _paged_case(2, 32, 4, 2, 64, 8, [20, 9], cuda)
    args = [c["q"], c["k"], c["v"], c["table"], c["lens"]]
    for i, bad, err in ((0, c["q"].half(), TypeError),             # dtype
                        (1, c["k"].transpose(1, 2).contiguous()
                         .transpose(1, 2), ValueError),           # layout
                        (3, c["table"].cpu(), ValueError)):         # device
        with pytest.raises(err):
            paged_decode_attention(*args[:i], bad, *args[i + 1:])
    with pytest.raises(TypeError):                 # int8 pools need scales
        paged_decode_attention(c["q"], c["k"].to(torch.int8),
                               c["v"].to(torch.int8), c["table"], c["lens"])
    q, k, v = _flash_case(1, 16, 16, 4, 2, 64, cuda)
    for i, bad, err in ((0, q.half(), TypeError),                  # dtype
                        (1, k.to(torch.bfloat16), TypeError),      # mixed
                        (2, v.transpose(1, 2).contiguous()
                         .transpose(1, 2), ValueError),           # layout
                        (1, k.cpu(), ValueError)):                 # device
        args = [q, k, v]
        args[i] = bad
        with pytest.raises(err):
            flash_attention(*args)
    with pytest.raises(ValueError):                # head_dim above 128
        flash_attention(*_flash_case(1, 8, 8, 2, 2, 136, cuda))


def _paged_case(b, t, h, kh, d, page, lens, dev, *, qs=1, alloc="striped",
                dtype=torch.float32, seed=0):
    """A random K/V history of t tokens scattered into page pools through
    a ``default_page_table``, and q rows at the end of each context."""
    table = default_page_table(b, t // page, alloc)
    hist_k = _randn((b, t, kh, d), seed, "cpu")
    hist_v = _randn((b, t, kh, d), seed + 1, "cpu")

    def pool(hist):
        out = torch.empty((b * (t // page), page, kh, d))
        out[table.flatten().long()] = hist.reshape(-1, page, kh, d)
        return out.to(dtype).to(dev)

    return {"q": _randn((b, qs, h, d), seed + 2, dev).to(dtype),
            "k": pool(hist_k), "v": pool(hist_v), "table": table.to(dev),
            "lens": torch.tensor(lens, dtype=torch.int32, device=dev)}


# b, t, h, kh, d, page, lens, options: distilbert decode and prefill,
# a chunked prefill in q blocks, GQA at head_dim 128, window + softcap
PAGED_CASES = {
    "decode": (4, 80, 12, 12, 64, 16, [65, 49, 34, 18], {}),
    "prefill": (4, 64, 12, 12, 64, 16, [64] * 4, dict(qs=64)),
    "chunked": (2, 208, 12, 12, 64, 16, [200, 200],
                dict(qs=200, q_chunk=128)),
    "gqa": (2, 256, 16, 2, 128, 64, [256, 77], {}),
    "window_softcap": (2, 128, 4, 1, 64, 16, [100, 23],
                       dict(window=20, softcap=50.0)),
    # phi-3-vision's text decoder: MHA (32/32 heads) at head dim 96
    "mha_d96_decode": (4, 96, 32, 32, 96, 16, [65, 49, 34, 18], {}),
    "mha_d96_prefill": (2, 208, 32, 32, 96, 16, [200, 140],
                        dict(qs=200, q_chunk=128)),
}


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_decode_kernel_matches_plain(cuda, case, mode):
    b, t, h, kh, d, page, lens, opts = PAGED_CASES[case]
    opts = dict(opts)
    qs = opts.pop("qs", 1)
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    c = _paged_case(b, t, h, kh, d, page, lens, cuda, qs=qs, dtype=dtype)
    if mode == "int8":
        (c["k"], opts["k_scales"]), (c["v"], opts["v_scales"]) = (
            quantize_kv(c["k"]), quantize_kv(c["v"]))
    out = paged_decode_attention(c["q"], c["k"], c["v"], c["table"],
                                 c["lens"], **opts)
    torch.cuda.synchronize()
    want = paged_ref.paged_decode_attention_ref(c["q"], c["k"], c["v"],
                                                c["table"], c["lens"], **opts)
    assert out.shape == want.shape and out.dtype == want.dtype
    if mode == "bf16":
        # the kernel rounds the unnormalised p to bf16, the plain version p/l
        err = _row_rel_err(out, want)
        assert err <= 1e-2, err
    else:
        torch.testing.assert_close(out, want, atol=5e-6, rtol=1e-5)


def test_paged_decode_kernel_bitwise_invariants(cuda):
    b, t, h, kh, d, page, lens = 4, 80, 12, 12, 64, 16, [65, 49, 34, 18]
    outs = [paged_decode_attention(c["q"], c["k"], c["v"], c["table"],
                                   c["lens"])
            for c in (_paged_case(b, t, h, kh, d, page, lens, cuda,
                                  alloc=alloc)
                      for alloc in ("striped", "contiguous"))]
    assert torch.equal(outs[0], outs[1])
    c = _paged_case(b, t, h, kh, d, page, lens, cuda, qs=3)
    (kq, ks), (vq, vs) = quantize_kv(c["k"]), quantize_kv(c["v"])
    got = paged_decode_attention(c["q"], kq, vq, c["table"], c["lens"],
                                 k_scales=ks, v_scales=vs, window=20)
    fp = paged_decode_attention(c["q"], kq.float() * ks[..., None],
                                vq.float() * vs[..., None], c["table"],
                                c["lens"], window=20)
    torch.cuda.synchronize()
    assert torch.equal(got, fp)


# b, t, h, kh, d, page, committed lens, new_lens, options: the served
# shape (qwen2.5-3b's heads, n_draft 4), the reference test's, a window
VERIFY_CASES = {
    "served": (4, 576, 16, 2, 128, 16, [40, 300, 120, 555], [5, 5, 0, 5],
               {}),
    "reference": (2, 64, 4, 2, 16, 8, [36, 20], [3, 1], {}),
    "window": (3, 64, 8, 1, 64, 16, [48, 10, 30], [2, 4, 1],
               dict(window=12)),
}


def _verify_case(case, mode, dev):
    b, t, h, kh, d, page, committed, new_lens, opts = VERIFY_CASES[case]
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    lens = [c + n for c, n in zip(committed, new_lens)]
    c = _paged_case(b, t, h, kh, d, page, lens, dev, qs=5, dtype=dtype)
    opts = dict(opts)
    if mode == "int8":
        (c["k"], opts["k_scales"]), (c["v"], opts["v_scales"]) = (
            quantize_kv(c["k"]), quantize_kv(c["v"]))
    c["new_lens"] = torch.tensor(new_lens, dtype=torch.int32, device=dev)
    return c, opts


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", list(VERIFY_CASES))
def test_paged_verify_kernel_matches_plain(cuda, case, mode):
    """Verify mode against the plain version: live rows within the limits
    (bf16: each row at 1e-2 of its own largest value), dead rows exactly
    0."""
    c, opts = _verify_case(case, mode, cuda)
    args = (c["q"], c["k"], c["v"], c["table"], c["lens"])
    reset_launch_counts()
    out = paged_decode_attention(*args, new_lens=c["new_lens"], **opts)
    torch.cuda.synchronize()
    assert launch_counts()["paged_decode_verify"] == 1
    want = paged_ref.paged_decode_attention_ref(*args, new_lens=c["new_lens"],
                                                **opts)
    for b, n in enumerate(c["new_lens"].tolist()):
        assert torch.equal(out[b, n:], torch.zeros_like(out[b, n:]))
    if mode == "bf16":
        diff = (out.float() - want.float()).abs().amax(-1)
        size = want.float().abs().amax(-1)
        assert bool((diff <= 1e-2 * size).all())
    else:
        torch.testing.assert_close(out, want, atol=5e-6, rtol=1e-5)


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("window", [None, 20])
def test_paged_verify_one_row_is_the_plain_launch(cuda, mode, window):
    """new_lens of all ones is bitwise the plain 1-row launch."""
    b, t, h, kh, d, page, lens = 4, 80, 16, 2, 128, 16, [65, 49, 34, 18]
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    c = _paged_case(b, t, h, kh, d, page, lens, cuda, dtype=dtype)
    opts = dict(window=window)
    if mode == "int8":
        (c["k"], opts["k_scales"]), (c["v"], opts["v_scales"]) = (
            quantize_kv(c["k"]), quantize_kv(c["v"]))
    args = (c["q"], c["k"], c["v"], c["table"], c["lens"])
    plain = paged_decode_attention(*args, **opts)
    verify = paged_decode_attention(*args, new_lens=torch.ones_like(c["lens"]),
                                    **opts)
    torch.cuda.synchronize()
    assert torch.equal(plain, verify)


def test_paged_verify_variable_rows(cuda):
    """Live rows agree with an exact-width launch per sequence in f32; an
    idle sequence (new_lens 0) gives zeros."""
    c, opts = _verify_case("reference", "f32", cuda)
    args = (c["q"], c["k"], c["v"], c["table"], c["lens"])
    out = paged_decode_attention(*args, new_lens=c["new_lens"])
    for b, n in enumerate(c["new_lens"].tolist()):
        want = paged_decode_attention(c["q"][b:b + 1, :n].contiguous(),
                                      c["k"], c["v"],
                                      c["table"][b:b + 1],
                                      c["lens"][b:b + 1])
        torch.testing.assert_close(out[b, :n], want[0], atol=5e-6,
                                   rtol=1e-5)
    idle = paged_decode_attention(c["q"], c["k"], c["v"], c["table"],
                                  c["lens"] * 0, new_lens=c["new_lens"] * 0)
    torch.cuda.synchronize()
    assert not idle.any()


# b, t, h, kh, d, page, lens: contexts of ~4096 tokens, whose walks span
# many splits, in pages of 16 and of 64 (qwen2.5-3b's heads)
SPLIT_CASES = {
    "page16": (2, 4096, 16, 2, 128, 16, [4096, 2999]),
    "page64": (2, 4096, 16, 2, 128, 64, [4090, 3001]),
}


def _quantized(c):
    (kq, ks), (vq, vs) = quantize_kv(c["k"]), quantize_kv(c["v"])
    return dict(c, k=kq, v=vq), dict(k_scales=ks, v_scales=vs)


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_paged_decode_multi_split_invariants(cuda, case, verify, mode):
    """Contexts that span several splits of the page walk: the kernel
    within its limits of the plain version, and its four bitwise
    contracts: two launches agree, striped and contiguous tables agree, a
    one-row verify launch is the plain launch, int8 pools are their f32
    pools dequantized beforehand."""
    b, t, h, kh, d, page, lens = SPLIT_CASES[case]
    qs, new_lens = (5, [5, 3]) if verify else (1, None)
    plan = split_plan(b, kh, h // kh,
                      flash_decode_schedule(t // page, page, q_len=qs))
    assert plan.n_splits > 1
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32

    def launch(c, **kw):
        if mode == "int8":
            c, scales = _quantized(c)
            kw.update(scales)
        return paged_decode_attention(c["q"], c["k"], c["v"], c["table"],
                                      c["lens"], **kw)

    c = _paged_case(b, t, h, kh, d, page, lens, cuda, qs=qs, dtype=dtype)
    opts = {}
    if verify:
        opts["new_lens"] = torch.tensor(new_lens, dtype=torch.int32,
                                        device=cuda)
    out = launch(c, **opts)
    again = launch(c, **opts)
    contiguous = launch(_paged_case(b, t, h, kh, d, page, lens, cuda, qs=qs,
                                    dtype=dtype, alloc="contiguous"), **opts)
    one = dict(c, q=c["q"][:, :1].contiguous())
    plain_one = launch(one)
    verify_one = launch(one, new_lens=torch.ones_like(c["lens"]))
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert torch.equal(out, contiguous)
    assert torch.equal(plain_one, verify_one)

    cq, scales = _quantized(c) if mode == "int8" else (c, {})
    want = paged_ref.paged_decode_attention_ref(
        cq["q"], cq["k"], cq["v"], cq["table"], cq["lens"], **scales,
        **opts)
    if verify:
        for i, n in enumerate(new_lens):
            assert not out[i, n:].any()
    if mode == "bf16":
        err = _row_rel_err(out, want)
        assert err <= 1e-2, err
    else:
        torch.testing.assert_close(out, want, atol=5e-6, rtol=1e-5)
    if mode == "int8":
        fp = paged_decode_attention(
            cq["q"], cq["k"].float() * scales["k_scales"][..., None],
            cq["v"].float() * scales["v_scales"][..., None], cq["table"],
            cq["lens"], **opts)
        torch.cuda.synchronize()
        assert torch.equal(out, fp)


def _flash_case(b, s, t, h, kh, d, dev, dtype=torch.float32, seed=0):
    """q (B, S, H, D) and k, v (B, T, KH, D), normal, on ``dev``."""
    return tuple(_randn(shape, seed + i, dev).to(dtype)
                 for i, shape in enumerate(((b, s, h, d), (b, t, kh, d),
                                            (b, t, kh, d))))


# b, s, t, h, kh, d, options: GQA causal at qwen2.5's head shape, MHA at
# distilbert's, MQA with softcap, gemma2-style window + softcap, partial S
# and T, non-causal with a window (rows that see nothing), S != T, head_dim
# not a multiple of the 16-byte load, a walk over many KV tiles
FLASH_CASES = {
    "gqa8_d128": (1, 200, 200, 16, 2, 128, {}),
    "mha_d64": (2, 130, 130, 12, 12, 64, {}),
    "mqa_softcap": (2, 128, 128, 4, 1, 64, dict(softcap=30.0)),
    "window_softcap": (1, 300, 300, 8, 4, 128, dict(window=70, softcap=50.0)),
    "partial": (1, 77, 77, 4, 4, 64, {}),
    "noncausal_window": (1, 160, 40, 4, 2, 32, dict(causal=False, window=48)),
    "s_ne_t": (1, 100, 200, 4, 4, 16, dict(causal=False, softcap=50.0)),
    "odd_d": (1, 90, 90, 4, 2, 18, dict(window=20)),
    "long_walk": (1, 2048, 2048, 16, 2, 128, {}),
    # zamba2-7b's shared block: MHA (g = 1) at head dim 112 (zero-padded
    # to 128 in the bf16 kernel)
    "mha_d112": (1, 1024, 1024, 32, 32, 112, {}),
    # seamless-m4t-medium's encoder: MHA at head dim 64, bidirectional
    "mha_d64_noncausal": (2, 1024, 1024, 16, 16, 64, dict(causal=False)),
    # phi-3-vision: MHA at head dim 96 (zero-padded to 128 in bf16)
    "mha_d96": (1, 1024, 1024, 32, 32, 96, {}),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    b, s, t, h, kh, d, opts = FLASH_CASES[case]
    q, k, v = _flash_case(b, s, t, h, kh, d, cuda, dtype)
    reset_launch_counts()
    out = flash_attention(q, k, v, **opts)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 1
    want = paged_ref.attention_ref(q, k, v, **opts)
    assert out.shape == want.shape and out.dtype == want.dtype
    if dtype == torch.bfloat16:
        # the kernel rounds the unnormalised p to bf16, the plain version
        # p/l: each row within 1e-2 of its own largest value
        err = _row_rel_err(out, want)
        assert err <= 1e-2, err
    else:
        torch.testing.assert_close(out, want, atol=5e-6, rtol=1e-5)


def test_flash_attention_kernel_is_deterministic(cuda):
    q, k, v = _flash_case(1, 300, 300, 8, 4, 128, cuda, torch.bfloat16)
    a = flash_attention(q, k, v, window=70, softcap=50.0)
    b = flash_attention(q, k, v, window=70, softcap=50.0)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# the backward's cases: those of the forward, a row that sees no key
# (non-causal window past T), qwen2.5-3b's GQA-8 training layout over a
# long walk, and seamless's non-causal encoder at D = 64
BWD_CASES = ["gqa8_d128", "mha_d64", "mqa_softcap", "window_softcap",
             "partial", "noncausal_window", "s_ne_t", "odd_d", "mha_d112",
             "mha_d96", "long_walk", "mha_d64_noncausal"]


def _flash_grads(q, k, v, dout, opts):
    """K5's output and its dQ, dK, dV through autograd on the card."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = flash_attention(q, k, v, **opts)
    return (out.detach(),) + torch.autograd.grad(out, (q, k, v), dout)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_attention_backward_matches_plain(cuda, case, dtype):
    """dQ, dK, dV of K5's backward kernels against the step-by-step plain
    backward and against autograd through the plain forward: f32 within
    atol 1e-5 / rtol 1e-4, bf16 each row within 2e-2 of its largest
    value (``_grad_row_rel_err``); the log-sum-exps within 1e-5 relative (+inf on rows that see no
    key)."""
    b, s, t, h, kh, d, opts = FLASH_CASES[case]
    q, k, v = _flash_case(b, s, t, h, kh, d, cuda, dtype)
    dout = _randn((b, s, h, d), 7, cuda).to(dtype)
    reset_launch_counts()
    out, dq, dk, dv = _flash_grads(q, k, v, dout, opts)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_backward"]) \
        == (1, 1)
    plain = paged_ref.attention_bwd_ref(q, k, v, dout, **opts)
    qa, ka, va = (x.detach().float().requires_grad_() for x in (q, k, v))
    auto = torch.autograd.grad(paged_ref.attention_ref(qa, ka, va, **opts),
                               (qa, ka, va), dout.float())
    for got, want, want_auto in zip((dq, dk, dv), plain, auto):
        assert got.dtype == dtype and got.shape == want.shape
        if dtype == torch.bfloat16:
            assert _grad_row_rel_err(got, want.float()) <= 2e-2
            assert _grad_row_rel_err(got, want_auto) <= 2e-2
        else:
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
            torch.testing.assert_close(got, want_auto, atol=1e-5, rtol=1e-4)
    if dtype == torch.float32:
        from repro_torch.kernels.flash_attention.ops import _flash_forward
        _, lse, _ = _flash_forward(q, k, v, d ** -0.5, opts.get("causal", True),
                                opts.get("window"), opts.get("softcap"),
                                with_lse=True)
        want = paged_ref.attention_lse_ref(q, k, **opts)
        assert torch.equal(torch.isinf(lse), torch.isinf(want))
        fin = torch.isfinite(want)
        torch.testing.assert_close(lse[fin], want[fin], atol=1e-5,
                                   rtol=1e-5)


def test_flash_attention_backward_no_key_rows_are_zero(cuda):
    """Rows that see no key give O = 0 and exactly zero gradients."""
    q, k, v = _flash_case(1, 200, 64, 4, 2, 32, cuda)
    opts = dict(causal=False, window=32)
    dout = _randn((1, 200, 4, 32), 7, cuda)
    out, dq, dk, dv = _flash_grads(q, k, v, dout, opts)
    torch.cuda.synchronize()
    dead = slice(96, None)               # s - 32 >= 63: no key t > s - 32
    assert torch.equal(out[:, dead], torch.zeros_like(out[:, dead]))
    assert torch.equal(dq[:, dead], torch.zeros_like(dq[:, dead]))
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_output_unchanged_by_lse(cuda, dtype):
    """The forward writes the same O with and without the log-sum-exps,
    and the backward gives the same bits twice."""
    from repro_torch.kernels.flash_attention.ops import _flash_forward
    q, k, v = _flash_case(1, 300, 300, 8, 4, 128, cuda, dtype)
    opts = (128 ** -0.5, True, 70, 50.0)
    plain, _, _ = _flash_forward(q, k, v, *opts, with_lse=False)
    with_lse, _, out32 = _flash_forward(q, k, v, *opts, with_lse=True)
    assert torch.equal(plain, with_lse)
    assert torch.equal(out32.to(dtype), plain)
    dout = _randn((1, 300, 8, 128), 7, cuda).to(dtype)
    kw = dict(window=70, softcap=50.0)
    a = _flash_grads(q, k, v, dout, kw)
    b = _flash_grads(q, k, v, dout, kw)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("case", ["window_softcap", "long_walk"])
def test_flash_attention_backward_bf16_is_deterministic(cuda, case):
    """Two bf16 backward runs give the same bits: no atomics, and the g
    heads' dK dV shares are added in head order."""
    b, s, t, h, kh, d, opts = FLASH_CASES[case]
    q, k, v = _flash_case(b, s, t, h, kh, d, cuda, torch.bfloat16)
    dout = _randn((b, s, h, d), 7, cuda).to(torch.bfloat16)
    first = _flash_grads(q, k, v, dout, opts)
    second = _flash_grads(q, k, v, dout, opts)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def test_kernels_without_backward_raise_under_autograd(cuda):
    """K1-K4 refuse inputs that require grad instead of returning a
    detached output; under no_grad they launch."""
    x = _randn((8, 64), 0, cuda).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        quant_act(x)
    with pytest.raises(RuntimeError, match="no backward"):
        quant_act_glu(x, x)
    xq = quant_act(x.detach())
    xq_grad = type(xq)(xq.values, xq.scale.requires_grad_(), xq.bits)
    w = quantize_weight(_randn((64, 32), 1, cuda))
    with pytest.raises(RuntimeError, match="no backward"):
        tiled_matmul(xq_grad, w)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_qkv(xq_grad, w, w, w)
    c = _paged_case(2, 32, 4, 2, 64, 8, [20, 9], cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        paged_decode_attention(c["q"].requires_grad_(), c["k"], c["v"],
                               c["table"], c["lens"])
    with torch.no_grad():
        tiled_matmul(xq_grad, w)
        paged_decode_attention(c["q"], c["k"], c["v"], c["table"],
                               c["lens"])


def test_jnp_blockwise_path_raises_on_the_card(cuda):
    """``attn_impl="jnp"`` is the CPU's plain path: on the card a long
    prompt goes through K5 or nowhere."""
    cfg = get_smoke_config("qwen2_5_3b").replace(dtype="float32",
                                                 attn_impl="jnp")
    model = init_model(torch.Generator(device=cuda).manual_seed(0), cfg,
                       device=cuda)
    toks = torch.zeros((1, cfg.blockwise_attn_threshold), dtype=torch.long,
                       device=cuda)
    with pytest.raises(ValueError, match="CPU only"):
        apply_model(model, toks, cfg)


def test_scheduler_spec_serve_on_the_card(cuda):
    """The Scheduler's speculative serve on the card at smoke size: every
    target forward of a spec tick is one K4 verify launch per layer, and
    each admission's prefill a plain one."""
    from repro_torch.models.transformer import Model
    from repro_torch.serving.cache import CacheConfig
    from repro_torch.serving.scheduler import Scheduler, SpecConfig
    cfg = get_smoke_config("qwen2_5_3b").replace(quant_proj="none",
                                                 dtype="float32")
    model = init_model(torch.Generator(device=cuda).manual_seed(0), cfg,
                       device=cuda)
    draft = Model(model.embed, model.final_norm, list(model.layers[:1]),
                  model.lm_head)
    sched = Scheduler(model, cfg, slots=3, max_len=64, bucket=8, eos_id=5,
                      config=CacheConfig(layout="paged", alloc="dynamic",
                                         page_size=4, pool_pages=30),
                      spec=SpecConfig(draft, cfg.replace(n_layers=1), 3),
                      device=cuda)
    g = torch.Generator().manual_seed(1)
    for n, budget in ((7, 6), (12, 9), (5, 4), (20, 8)):
        sched.submit(torch.randint(0, cfg.vocab_size, (n,), generator=g),
                     budget)
    reset_launch_counts()
    out = sched.run(max_ticks=60)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["paged_decode_verify"] == sched.spec_stats["ticks"] * 3
    assert counts["paged_decode"] == len(out) * 3        # one prefill each
    assert sched.spec_stats["emitted"] == sum(len(v) - 1
                                              for v in out.values())
    for toks in out.values():
        assert toks.min() >= 0 and toks.max() < cfg.vocab_size
    assert sched.pool_occupancy().used == 1


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "granite_moe_3b_a800m"])
def test_apply_moe_on_the_card(cuda, arch):
    """The MoE block on the card: in bf16 with w8 experts two calls are
    bitwise equal (no atomics in the combine); in f32 with float experts
    (TF32 off) it routes as the CPU does and agrees within rel-err 1e-5."""
    import copy

    from repro_torch.core.quantize_params import quantize_model_params
    from repro_torch.models import moe
    cfg = get_smoke_config(arch).replace(dtype="float32")
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    block = model.layers[0].moe
    x = torch.randn((3, 40, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = copy.deepcopy(block).to(cuda)
        y, aux = moe.apply_moe(card, x.to(cuda), cfg)
        _, idx, _ = moe.route(card.router, x.to(cuda), cfg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    y_cpu, aux_cpu = moe.apply_moe(block, x, cfg)
    _, idx_cpu, _ = moe.route(block.router, x, cfg)
    assert torch.equal(idx.cpu(), idx_cpu)
    err = (y.cpu().double() - y_cpu.double()).abs().max() \
        / y_cpu.double().abs().max()
    assert err <= 1e-5
    assert abs(float(aux["load_balance_loss"])
               - float(aux_cpu["load_balance_loss"])) <= 1e-6

    qcard = quantize_model_params(card, quantize_experts=True)
    bcfg = cfg.replace(dtype="bfloat16")
    xb = x.to(cuda, torch.bfloat16)
    y1, _ = moe.apply_moe(qcard, xb, bcfg)
    y2, _ = moe.apply_moe(qcard, xb, bcfg)
    torch.cuda.synchronize()
    assert y1.dtype == torch.bfloat16 and torch.equal(y1, y2)
    assert bool(torch.isfinite(y1).all())


@pytest.mark.parametrize("arch", ["mamba2_370m", "zamba2_7b"])
def test_apply_mamba2_on_the_card(cuda, arch):
    """The Mamba2 block on the card in its three modes: in f32 ``none``
    (TF32 off) within rel-err 1e-5 of the CPU, state included; in bf16
    w8a8 one K1 serves the five in-projections and one out_proj (2 K1, 6
    K2 a call), and two calls are bitwise equal."""
    import copy

    from repro_torch.core.quantize_params import quantize_model_params
    from repro_torch.models import ssm
    cfg = get_smoke_config(arch).replace(quant_proj="none", dtype="float32")
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    block = model.layers[1].mamba
    g = torch.Generator().manual_seed(1)
    k = cfg.ssm_conv - 1
    state = {"h": torch.randn((3, cfg.ssm_n_heads, cfg.ssm_head_dim,
                               cfg.ssm_state), generator=g) * 0.3,
             "conv_x": torch.randn((3, k, cfg.d_inner), generator=g),
             "conv_B": torch.randn((3, k, cfg.ssm_state), generator=g),
             "conv_C": torch.randn((3, k, cfg.ssm_state), generator=g)}
    nv = torch.tensor([13, 5, 0])
    modes = {"cache-less": (torch.randn((3, 32, cfg.d_model), generator=g),
                            None, None),
             "decode": (torch.randn((3, 1, cfg.d_model), generator=g),
                        state, None),
             "prefill-commit": (torch.randn((3, 13, cfg.d_model),
                                            generator=g), state, nv)}

    def err(a, b):
        return ((a.cpu().double() - b.double()).abs().max()
                / b.double().abs().max()).item()

    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = copy.deepcopy(block).to(cuda)
        for name, (x, st, n_valid) in modes.items():
            y, new = ssm.apply_mamba2(
                card, x.to(cuda), cfg,
                state=None if st is None
                else {key: v.to(cuda) for key, v in st.items()},
                n_valid=None if n_valid is None else n_valid.to(cuda))
            y_cpu, new_cpu = ssm.apply_mamba2(block, x, cfg, state=st,
                                              n_valid=n_valid)
            assert err(y, y_cpu) <= 1e-5, name
            for key in new_cpu or {}:
                assert new[key].dtype == torch.float32
                assert err(new[key], new_cpu[key]) <= 1e-5, (name, key)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow

    qcard = quantize_model_params(card)
    bcfg = cfg.replace(quant_proj="w8a8", dtype="bfloat16")
    x = modes["cache-less"][0].to(cuda, torch.bfloat16)
    reset_launch_counts()
    y1, _ = ssm.apply_mamba2(qcard, x, bcfg)
    counts = launch_counts()
    y2, _ = ssm.apply_mamba2(qcard, x, bcfg)
    torch.cuda.synchronize()
    assert counts["quant_act"] == 2 and counts["tiled_matmul"] == 6
    assert y1.dtype == torch.bfloat16 and torch.equal(y1, y2)
    assert bool(torch.isfinite(y1).all())


@pytest.mark.parametrize("mode", ["w8a8", "none"])
def test_cross_attention_on_the_card(cuda, mode):
    """seamless-m4t's cross-attention at smoke size: in f32 ``none`` (TF32
    off) within rel-err 1e-5 of the CPU; under w8a8 in bf16 one K1 of the
    memory rows serves K and V (3 K1 and 4 K2 a call, no K3, no K4 / K5),
    bitwise the plain versions run on the card's own operands."""
    import copy

    from repro_torch.core.quantize_params import quantize_model_params
    from repro_torch.models.attention import apply_attention
    cfg = get_smoke_config("seamless_m4t_medium").replace(
        quant_proj=mode, dtype="float32")
    model = init_model(torch.Generator().manual_seed(0),
                       cfg.replace(quant_proj="none"), device="cpu")
    block = model.layers[1].cross
    if mode == "w8a8":
        block = quantize_model_params(block)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((3, 7, cfg.d_model), generator=g)
    mem = torch.randn((3, 40, cfg.d_model), generator=g)
    pos = torch.arange(7)
    card = copy.deepcopy(block).to(cuda)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if mode == "none":
            y, _ = apply_attention(card, x.to(cuda), cfg,
                                   positions=pos.to(cuda),
                                   memory=mem.to(cuda))
            want, _ = apply_attention(block, x, cfg, positions=pos,
                                      memory=mem)
            err = ((y.cpu().double() - want.double()).abs().max()
                   / want.double().abs().max()).item()
            assert err <= 1e-5, err
            return
        bcfg = cfg.replace(dtype="bfloat16")
        xb, mb = (t.to(cuda, torch.bfloat16) for t in (x, mem))
        reset_launch_counts()
        y, _ = apply_attention(card, xb, bcfg, positions=pos.to(cuda),
                               memory=mb)
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    assert {k: n for k, n in counts.items() if n} == {"quant_act": 3,
                                                      "tiled_matmul": 4}
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())
    from repro_torch.core import quantized_linear as ql
    from repro_torch.core.quantization import QTensor

    def plain_quant(v):
        values, scale = quant_ref.quant_act_ref(v)
        return QTensor(values=values, scale=scale, bits=8)

    def plain_matmul(a, b, bias=None, *, out_dtype=torch.bfloat16):
        return matmul_ref.tiled_matmul_ref(a.values, a.scale, b.values,
                                           b.scale, bias, out_dtype)

    saved = ql.quant_act, ql.tiled_matmul
    ql.quant_act, ql.tiled_matmul = plain_quant, plain_matmul
    try:
        plain, _ = apply_attention(card, xb, bcfg, positions=pos.to(cuda),
                                   memory=mb)
    finally:
        ql.quant_act, ql.tiled_matmul = saved
    torch.cuda.synchronize()
    assert torch.equal(y, plain)


def test_train_step_card_matches_cpu(cuda):
    """One f32 train step of the smoke qwen2.5-3b config over 64 tokens
    (its blockwise threshold: K5 and its backward on the card, the plain
    version on the CPU): loss within 1e-5 relative, each gradient within
    1e-4 relative norm; the updated parameters finite and their update
    within AdamW's bound (lr and the weight decay's share); K5 launched
    twice a layer (the forward and the remat recompute), its backward
    once, K1-K4 never."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.training.train_step import (TrainState, make_loss_fn,
                                                 make_train_step, trainable,
                                                 value_and_grad)
    cfg = get_smoke_config("qwen2_5_3b").replace(dtype="float32")
    out = {}
    for dev in ("cpu", cuda):
        model = init_model(torch.Generator().manual_seed(0), cfg, device=dev)
        batch = SyntheticLM(cfg.vocab_size, 2, 64, seed=0,
                            device=dev).batch_at(0)
        reset_launch_counts()
        grads, metrics = value_and_grad(make_loss_fn(cfg), model,
                                        trainable(model), batch)
        counts = launch_counts()
        opt = AdamW(learning_rate=warmup_cosine(1e-3, 2, 10))
        state, _ = make_train_step(cfg, opt)(TrainState.create(model, opt),
                                             batch)
        out[str(dev)] = (float(metrics["loss"]),
                         {n: g.cpu() for n, g in grads.items()},
                         {n: p.cpu() for n, p in
                          trainable(state.params).items()}, counts)
    (loss_c, grads_c, _, _), (loss_g, grads_g, params_g, counts) = (
        out["cpu"], out[str(cuda)])
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    for name, g in grads_c.items():
        rel = float(torch.linalg.norm(grads_g[name] - g)
                    / torch.linalg.norm(g).clamp_min(1e-30))
        assert rel <= 1e-4, (name, rel)
    p0 = trainable(init_model(torch.Generator().manual_seed(0), cfg,
                              device="cpu"))
    for name, p in params_g.items():
        # lr 5e-4 at step 1; |m / (sqrt(v) + eps)| <= 1, decay 0.1 |p|
        step = (p - p0[name]).abs().max().item()
        bound = 5e-4 * (1 + 0.1 * p0[name].abs().max().item()) * (1 + 1e-5)
        assert bool(torch.isfinite(p).all()) and step <= bound, name
    assert counts["flash_attention"] == 2 * cfg.n_layers
    assert counts["flash_attention_backward"] == cfg.n_layers
    assert sum(n for k, n in counts.items() if not k.startswith("flash")) \
        == 0


# ---------------------------------------------------------------------------
# the row-parallel modes of K1 and K2 (a serving mesh's wo and down)
# ---------------------------------------------------------------------------
def _parts(x, n):
    """x's columns in n equal contiguous slices (each rank's input)."""
    k = x.shape[1] // n
    return [x[:, i * k:(i + 1) * k].contiguous() for i in range(n)]


@pytest.mark.parametrize("glu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,n", [((4, 12288), 4), ((256, 7168), 4),
                                     ((129, 5504), 2), ((5, 776), 2)])
def test_k1_absmax_modes_rebuild_the_whole_rows_quantization(cuda, shape, n,
                                                             dtype, glu):
    """K1's absmax mode of each slice of the rows, then its given-absmax
    mode with the slices' maximum, is bitwise K1 of the whole rows (and
    each launch is bitwise its plain version)."""
    from repro_torch.kernels.quant_act.ops import row_absmax
    x = _randn(shape, 1, cuda, 3.0).to(dtype)
    x[0] = 0
    up = _randn(shape, 2, cuda).to(dtype) if glu else None
    whole = quant_act_glu(x, up) if glu else quant_act(x)
    xs = _parts(x, n)
    ups = _parts(up, n) if glu else [None] * n
    reset_launch_counts()
    maxes = [row_absmax(a, u) for a, u in zip(xs, ups)]
    for a, u, got in zip(xs, ups, maxes):
        want = (quant_ref.row_absmax_glu_ref(a, u) if glu
                else quant_ref.row_absmax_ref(a))
        assert torch.equal(got, want)
    absmax = torch.stack(maxes).amax(0)
    for i, (a, u) in enumerate(zip(xs, ups)):
        got = (quant_act_glu(a, u, absmax=absmax) if glu
               else quant_act(a, absmax=absmax))
        want = (quant_ref.quant_act_glu_ref(a, u, absmax=absmax) if glu
                else quant_ref.quant_act_ref(a, absmax=absmax))
        k = a.shape[1]
        assert torch.equal(got.values, whole.values[:, i * k:(i + 1) * k])
        assert torch.equal(got.scale, whole.scale)
        assert torch.equal(got.values, want[0])
        assert torch.equal(got.scale, want[1])
    counts = launch_counts()
    assert counts["row_absmax"] == n
    assert counts["quant_act_glu" if glu else "quant_act"] == n


@pytest.mark.parametrize("m,k,n,parts", [(4, 12288, 2048, 4),
                                         (256, 7168, 1536, 4),
                                         (4, 5504, 2048, 2),
                                         (40, 2752, 2048, 4)])
def test_k2_int32_and_epilogue_modes_rebuild_the_whole_product(cuda, m, k, n,
                                                               parts):
    """K2's int32-out mode over slices of K, summed, then its epilogue
    mode, is bitwise K2 over the whole K (and each launch is bitwise its
    plain version)."""
    from repro_torch.core.quantization import QTensor
    from repro_torch.kernels.tiled_matmul.ops import (int8_epilogue,
                                                      tiled_matmul_int32)
    a, (b,) = _operands(m, k, [n], cuda, seed=7)
    bias = _randn((n,), 8, cuda)
    whole = tiled_matmul(a, b, bias, out_dtype=torch.bfloat16)
    step = k // parts
    reset_launch_counts()
    acc = None
    for i in range(parts):
        lo, hi = i * step, (i + 1) * step
        ai = QTensor(a.values[:, lo:hi].contiguous(), a.scale, 8)
        bi = QTensor(b.values[lo:hi].t().contiguous().t(), b.scale, 8)
        part = tiled_matmul_int32(ai, bi)
        assert torch.equal(part, matmul_ref.int_matmul_exact(ai.values,
                                                             bi.values))
        acc = part if acc is None else acc + part
    for out_dtype in (torch.bfloat16, torch.float32):
        got = int8_epilogue(acc, a.scale, b, bias, out_dtype=out_dtype)
        assert torch.equal(got, matmul_ref.int8_epilogue_ref(
            acc, a.scale, b.scale, bias, out_dtype))
    assert torch.equal(int8_epilogue(acc, a.scale, b, bias), whole)
    counts = launch_counts()
    assert counts["tiled_matmul_int32"] == parts
    assert counts["int8_epilogue"] == 3


@pytest.mark.parametrize("plan", [GemmPlan("swap", 8, 1, 24),
                                  GemmPlan("swap", 8, 4, 6),
                                  GemmPlan("swap", 64, 3, 8)])
def test_k2_int32_mode_takes_every_swap_split(cuda, plan):
    """The int32-out mode under forced swap plans, split or not: the exact
    product; the wide variant is refused (it has no int32 output)."""
    from repro_torch.kernels.tiled_matmul.ops import tiled_matmul_int32
    a, (b,) = _operands(4 if plan.cols == 8 else 100, 3072, [1024], cuda)
    got = tiled_matmul_int32(a, b, plan=plan)
    assert torch.equal(got, matmul_ref.int_matmul_exact(a.values, b.values))
    with pytest.raises(ValueError, match="swap"):
        tiled_matmul_int32(a, b, plan=GemmPlan("wide", 256, 1, 24))


def test_mesh_serving_on_one_card(cuda):
    """Ranks sharing the card over gloo: qwen2.5-3b's smoke config (w8a8,
    bf16 pools) serves one trace through the Scheduler; mesh 2 (heads,
    K4 on each rank's KV head, planned as the unsharded launch) gives mesh
    1's tokens, and on mesh 4 (pages) every rank emits the same tokens at
    every tick."""
    import sys
    from pathlib import Path

    import numpy as np

    from repro_torch.bridge import params_to_numpy
    from repro_torch.core.quantize_params import quantize_model_params
    from repro_torch.launch.mesh import spawn_ranks
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import _torch_mesh_ranks as ranks
    cfg = get_smoke_config("qwen2_5_3b").replace(quant_proj="w8a8",
                                                 dtype="bfloat16")
    model = quantize_model_params(init_model(
        torch.Generator().manual_seed(0), cfg.replace(quant_proj="none"),
        device="cpu"))
    tree = params_to_numpy(model, cfg)
    rng = np.random.default_rng(3)
    trace = [(t, rng.integers(0, cfg.vocab_size, n), b)
             for t, n, b in ((0, 9, 4), (0, 13, 5), (1, 15, 3), (2, 5, 4))]
    cache_kw = dict(layout="paged", alloc="dynamic", page_size=4,
                    pool_pages=24)
    sched_kw = dict(slots=3, max_len=64, bucket=4, dtype=torch.bfloat16)
    runs = {m: spawn_ranks(ranks.sched_trace, m, backend="gloo",
                           device="cuda:0",
                           args=(tree, cfg, trace, cache_kw, sched_kw),
                           timeout=300)
            for m in (1, 2, 4)}
    for a, b in zip(runs[2][0]["tokens"], runs[1][0]["tokens"]):
        assert np.array_equal(a, b)
    assert [r["policy"] for r in runs[4]] == ["pages"] * 4
    for r in runs[4][1:]:
        assert r["ticks"] == runs[4][0]["ticks"]
