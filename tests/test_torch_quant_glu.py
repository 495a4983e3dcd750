"""K1's SwiGLU mode (``quant_act_glu``), the w8a8 FFN that shares one K1
between gate and up, and K1's row planner, on the CPU against the JAX
package.

Tolerances: the port against itself is bitwise (the CPU runs the plain
versions, and the fused FFN is the same composition with fewer launches).
Against JAX, ``apply_ffn`` keeps the port's usual limits (rel-err 1e-5 for
``none`` and ``w8``, 2e-3 for ``w8a8``, ``test_torch_model.py``).  The
SwiGLU product itself differs between the frameworks: ``jax.nn.silu`` is
``x * sigmoid(x)`` and torch's ``x / (1 + exp(-x))``, so the two differ by
ulps at rounding boundaries.  In f32 that flips few int8 roundings: scales
within a rel-err of 1e-6, values within 1 with at most 1e-3 of them
differing.  In bf16 each op rounds to 8 bits: the products differ in about
a third of their elements, by up to 3 bf16 ulps (JAX rounds sigmoid and
then the product, torch the quotient once), so there the products are held
within 4 ulps of each other and the quantization of the port's product is
held bitwise to the JAX package's kernel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as jax_configs
from repro.core.quantized_linear import quantize_linear as jax_quantize_linear
from repro.kernels.quant_act.ops import quant_act as jax_quant_act
from repro.models import ffn as jax_ffn
from repro_torch.configs import get_smoke_config
from repro_torch.core import quantized_linear as qlinear
from repro_torch.core.quantized_linear import (Linear, apply_linear,
                                               quantize_linear)
from repro_torch.kernels.quant_act import ops as quant_ops
from repro_torch.kernels.quant_act.ops import (MAX_SPLIT, QuantPlan,
                                               candidate_plans, check_plan,
                                               max_per, quant_act,
                                               quant_act_glu, quant_plan)
from repro_torch.kernels.quant_act.ref import (quant_act_glu_ref,
                                               quant_act_ref)
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.ffn import FFN, apply_ffn
from test_torch_bridge import rel_err

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# ragged shapes, a K that is not a multiple of 8, a single row
GLU_SHAPES = [(37, 50), (5, 770), (1, 33), (64, 352)]


def _glu_pair(shape, dtype, seed):
    """gate and up as torch tensors (the given dtype) and as jax arrays of
    the same values; gate's row 0 is zero (a zero row of the product)."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=shape).astype(np.float32) * 3
    u = rng.normal(size=shape).astype(np.float32)
    g[0] = 0.0
    tg, tu = (torch.from_numpy(a).to(DTYPES[dtype]) for a in (g, u))
    jg, ju = (jnp.asarray(t.float().numpy()).astype(dtype) for t in (tg, tu))
    return tg, tu, jg, ju


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", GLU_SHAPES)
def test_quant_act_glu_is_quant_act_of_the_product(shape, dtype):
    tg, tu, _, _ = _glu_pair(shape, dtype, seed=shape[1])
    q = quant_act_glu(tg, tu)
    want = quant_act(F.silu(tg) * tu)
    assert torch.equal(q.values, want.values)
    assert torch.equal(q.scale, want.scale)
    v, s = quant_act_glu_ref(tg, tu)
    assert torch.equal(q.values, v) and torch.equal(q.scale, s)
    assert s[0, 0] == 1.0 and not v[0].any()           # the zero row
    h = torch.empty_like(tg)
    quant_act_glu(tg, tu, h_out=h)
    assert torch.equal(h, F.silu(tg) * tu)


@pytest.mark.parametrize("shape", GLU_SHAPES)
def test_quant_act_glu_matches_jax_f32(shape):
    tg, tu, jg, ju = _glu_pair(shape, "float32", seed=shape[0])
    q = quant_act_glu(tg, tu)
    qj = jax_quant_act(jax_ffn._ACT["swiglu"](jg) * ju,
                       mode="pallas_interpret")
    v, vj = q.values.numpy().astype(int), np.asarray(qj.values).astype(int)
    s, sj = q.scale.numpy(), np.asarray(qj.scale)
    assert np.max(np.abs(s - sj) / np.abs(sj)) <= 1e-6
    assert np.max(np.abs(v - vj)) <= 1
    assert np.mean(v != vj) <= 1e-3


@pytest.mark.parametrize("shape", GLU_SHAPES)
def test_quant_act_glu_matches_jax_bf16(shape):
    tg, tu, jg, ju = _glu_pair(shape, "bfloat16", seed=shape[0])
    h = torch.empty_like(tg)
    q = quant_act_glu(tg, tu, h_out=h)
    hj = np.asarray((jax_ffn._ACT["swiglu"](jg) * ju).astype(jnp.float32))
    hf = h.float().numpy()
    # a bf16 ulp of each element of the port's product (8 significant bits)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(hf), 1e-38))) - 7)
    assert np.all(np.abs(hf - hj) <= 4 * ulp)
    # the port's product through the JAX package's kernel (interpreted):
    # the same int8 values; the interpreted kernel divides by qmax as a
    # reciprocal multiply, so its scale may sit 1 ulp off (as in
    # test_torch_quant.py)
    qj = jax_quant_act(jnp.asarray(hf).astype(jnp.bfloat16),
                       mode="pallas_interpret")
    np.testing.assert_array_equal(q.values.numpy(), np.asarray(qj.values))
    np.testing.assert_allclose(q.scale.numpy(), np.asarray(qj.scale),
                               atol=1e-8, rtol=0)


def test_quant_act_glu_refuses_mismatched_operands():
    g = torch.zeros((4, 8))
    with pytest.raises(ValueError):
        quant_act_glu(g, torch.zeros((4, 9)))
    with pytest.raises(ValueError):
        quant_act_glu(g, torch.zeros((4, 8), dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        quant_act_glu(g, g, h_out=torch.zeros((4, 8), dtype=torch.float64))
    with pytest.raises(ValueError):
        quant_act_glu(torch.zeros(8), torch.zeros(8))


# ---------------------------------------------------------------------------
# the w8a8 FFN: one K1 for gate and up; SwiGLU through quant_act_glu
# ---------------------------------------------------------------------------
FFN_ARCHS = ["qwen2_5_3b", "gemma2_27b", "distilbert_paper"]   # the 3 types


def _ffn_pair(arch, mode, seed=0):
    """The same FFN in both packages (JAX-initialised master weights, both
    sides quantized by their own ``quantize_linear`` where ``mode`` is not
    'none'), and the configs."""
    jcfg = jax_configs.get_smoke_config(arch).replace(quant_proj=mode)
    tcfg = get_smoke_config(arch).replace(quant_proj=mode)
    master = jax_ffn.init_ffn(jax.random.PRNGKey(seed), jcfg)
    lins = {k: Linear(w=torch.from_numpy(np.array(v["w"])))
            for k, v in master.items()}
    if mode != "none":
        master = {k: jax_quantize_linear(v) for k, v in master.items()}
        lins = {k: quantize_linear(v) for k, v in lins.items()}
    return jcfg, master, tcfg, FFN(lins["up"], lins["down"], lins.get("gate"))


def _two_k1_ffn(params, x, cfg):
    """The FFN as ``apply_linear`` composes it, one K1 a projection."""
    act = ffn_mod._ACT[cfg.ffn_type]
    mode = cfg.quant_proj
    if params.gate is not None:
        h = act(apply_linear(params.gate, x, mode=mode)) \
            * apply_linear(params.up, x, mode=mode)
    else:
        h = act(apply_linear(params.up, x, mode=mode))
    return apply_linear(params.down, h, mode=mode)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["none", "w8", "w8a8"])
@pytest.mark.parametrize("arch", FFN_ARCHS)
def test_apply_ffn_is_the_two_k1_composition(arch, mode, dtype):
    _, _, tcfg, ffn = _ffn_pair(arch, mode)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 7, tcfg.d_model)).astype(np.float32)).to(DTYPES[dtype])
    y = apply_ffn(ffn, x, tcfg)
    assert y.shape == x.shape and y.dtype == x.dtype
    assert torch.equal(y, _two_k1_ffn(ffn, x, tcfg))


@pytest.mark.parametrize("mode", ["none", "w8", "w8a8"])
@pytest.mark.parametrize("arch", FFN_ARCHS)
def test_apply_ffn_matches_jax(arch, mode):
    jcfg, params, tcfg, ffn = _ffn_pair(arch, mode, seed=1)
    x = np.random.default_rng(4).normal(
        size=(2, 7, tcfg.d_model)).astype(np.float32)
    y = apply_ffn(ffn, torch.from_numpy(x), tcfg)
    yj = jax_ffn.apply_ffn(params, jnp.asarray(x), jcfg)
    assert rel_err(y.numpy(), yj) <= {"none": 1e-5, "w8": 1e-5,
                                      "w8a8": 2e-3}[mode]


# K1 launches of one w8a8 FFN: (quant_act, quant_act_glu)
FFN_K1 = {"qwen2_5_3b": (1, 1), "gemma2_27b": (2, 0),
          "distilbert_paper": (2, 0)}


@pytest.mark.parametrize("arch", FFN_ARCHS)
def test_gated_ffn_runs_one_k1_for_gate_and_up(arch, monkeypatch):
    _, _, tcfg, ffn = _ffn_pair(arch, "w8a8")
    calls = {"quant_act": 0, "quant_act_glu": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    # every K1 call of the FFN is made in core/quantized_linear
    monkeypatch.setattr(qlinear, "quant_act",
                        counted("quant_act", quant_act))
    monkeypatch.setattr(qlinear, "quant_act_glu",
                        counted("quant_act_glu", quant_act_glu))
    x = torch.randn((3, tcfg.d_model), generator=torch.Generator()
                    .manual_seed(0)).to(torch.bfloat16)
    apply_ffn(ffn, x, tcfg)
    assert (calls["quant_act"], calls["quant_act_glu"]) == FFN_K1[arch]


# ---------------------------------------------------------------------------
# the kernel's rounding rule, emulated in f32: the same int8 as rint of the
# IEEE quotient (csrc/quant_act.cu, ``quantize``)
# ---------------------------------------------------------------------------
def _kernel_rule(x, s):
    """``quantize`` of csrc/quant_act.cu in numpy f32 (each op rounds to
    nearest): rint(x * RN(1 / s)) by the 1.5 * 2^23 sum where that product
    is at least 2^-15 from every half-integer, else rint of the clipped
    IEEE quotient; then the clip.  Returns (int8 values, fast share)."""
    f32 = np.float32
    magic = f32(12582912.0)
    q = x * (f32(1) / s)
    total = q + magic
    t = q - (total - magic)
    fast = np.abs(t) < f32(0.5) - f32(2.0 ** -15)
    with np.errstate(invalid="ignore", divide="ignore"):
        v = np.clip(x / s, f32(-127), f32(127)) + magic
    n = np.where(fast, total.view(np.int32), v.view(np.int32)) - 0x4B400000
    return np.clip(n, -127, 127), fast.mean()


@pytest.mark.parametrize("seed", range(4))
def test_kernel_rounding_rule_is_rint_of_the_ieee_quotient(seed):
    """Rows over scales 2^-29 to 2^29, an eighth of each row placed within
    40 ulps of a half-integer multiple of the scale, one value at the
    absmax: the rule gives quant_act_ref's int8 everywhere."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((64, 2048))
         * np.exp(rng.uniform(-20, 20, (64, 1)))).astype(np.float32)
    s = np.abs(x).max(1, keepdims=True) / np.float32(127)
    k = rng.integers(-127, 127, (64, 256)) + 0.5
    ulps = rng.integers(-40, 40, (64, 256)) * 2.0 ** -17
    x[:, :256] = ((k + ulps) * s).astype(np.float32)
    v, s_ref = quant_act_ref(torch.from_numpy(x))
    n, fast = _kernel_rule(x, s_ref.numpy())
    np.testing.assert_array_equal(n, v.numpy().astype(np.int32))
    assert 0.8 < fast < 1.0          # the near-half values take the quotient


# ---------------------------------------------------------------------------
# quant_plan: every row covered exactly once, within the kernel's limits
# ---------------------------------------------------------------------------
PLAN_MS = [0, 1, 4, 5, 20, 129, 131, 132, 256, 1055, 1056, 8192]
PLAN_KS = [1, 7, 8, 64, 256, 768, 770, 1000, 1024, 1032, 2048, 3072, 4104,
           11008, 11000, 36864, 36865, 65535, 65536]
PLAN_KS += sorted(np.random.default_rng(7).integers(1, 65537, 24).tolist())


def _covered(plan, k):
    """How often each of a row's units (vectors, or values) is touched by
    the (block of the slice, thread, register) walk the kernel makes."""
    units = k // plan.vec
    group = plan.threads
    slice_ = -(-units // plan.split)
    seen = np.zeros(units, np.int64)
    for rank in range(plan.split):
        lo, hi = rank * slice_, min((rank + 1) * slice_, units)
        idx = lo + np.arange(group)[:, None] + np.arange(plan.per) * group
        np.add.at(seen, idx[idx < hi], 1)
    return seen


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", PLAN_KS)
def test_quant_plan_covers_each_row_once(k, dtype):
    dt = DTYPES[dtype]
    for m in PLAN_MS:
        for aligned in (True, False):
            for plan in candidate_plans(m, k, dt, aligned):
                check_plan(plan, m, k, dt, aligned)
                assert (_covered(plan, k) == 1).all(), (plan, m, k)
                assert plan.split <= MAX_SPLIT and plan.threads <= 512
                assert plan.per <= max_per(dt, plan.vec)
                assert plan.vec == 1 or (aligned and k % 8 == 0)
            assert quant_plan(m, k, dt, aligned) in candidate_plans(
                m, k, dt, aligned)


def test_quant_plan_at_the_served_shapes():
    """The mappings phase 6's timings chose (PERF.md §6)."""
    bf16 = torch.bfloat16
    want = {(256, 768): "block 1x96 v8 p1", (256, 3072): "block 1x384 v8 p1",
            (4, 2048): "block 1x256 v8 p1", (20, 2048): "block 1x256 v8 p1",
            (4, 11008): "cluster 8x192 v8 p1",
            (20, 11008): "cluster 8x192 v8 p1",
            (32, 11008): "cluster 8x192 v8 p1",
            (48, 11008): "cluster 6x256 v8 p1",
            (64, 11008): "cluster 5x288 v8 p1",
            (144, 11008): "cluster 2x352 v8 p2",
            (192, 11008): "cluster 2x352 v8 p2",
            (300, 11008): "block 1x480 v8 p3",
            (8192, 2048): "block 1x64 v8 p4",
            (8192, 11008): "block 1x352 v8 p4",
            (4, 36864): "cluster 8x288 v8 p2",
            (8192, 36864): "cluster 2x288 v8 p8",
            (5, 770): "cluster 8x128 v1 p1"}
    assert {shape: str(quant_plan(*shape, bf16, True))
            for shape in want} == want


# (plan, m, k, aligned) that check_plan refuses
MISFITS = [
    (QuantPlan("block", 8, 32, 1, 4), 4, 2048, True),      # rows uncovered
    (QuantPlan("block", 8, 64, 1, 4), 4, 2048, False),     # unaligned vec
    (QuantPlan("block", 8, 256, 1, 1), 4, 2044, True),     # K % 8
    (QuantPlan("block", 8, 32, 1, 9), 4, 2048, True),      # registers
    (QuantPlan("cluster", 8, 32, 9, 1), 4, 2048, True),    # cluster size
    (QuantPlan("cluster", 8, 32, 1, 8), 4, 2048, True),    # a 1-block cluster
    (QuantPlan("block", 8, 64, 2, 4), 4, 2048, True),      # a split block row
    (QuantPlan("block", 8, 48, 1, 8), 4, 2048, True),      # not whole warps
    (QuantPlan("cluster", 8, 32, 8, 1), 4, 48, True),      # empty slices
    (QuantPlan("lane", 8, 32, 1, 8), 4, 2048, True),       # no such mapping
]


@pytest.mark.parametrize("plan,m,k,aligned", MISFITS)
def test_check_plan_refuses_plans_that_do_not_fit(plan, m, k, aligned):
    with pytest.raises(ValueError, match="does not fit"):
        check_plan(plan, m, k, torch.bfloat16, aligned)


def test_wrappers_plan_on_the_card_only(monkeypatch):
    """The CPU runs the plain versions and never plans."""
    def refuse(*args):
        raise AssertionError("planned for a CPU tensor")
    monkeypatch.setattr(quant_ops, "quant_plan", refuse)
    x = torch.randn((4, 16))
    v, s = quant_act_ref(x)
    q = quant_act(x)
    assert torch.equal(q.values, v) and torch.equal(q.scale, s)
    quant_act_glu(x, x)


def test_reset_launch_counts_clears_the_launches_by_plan():
    """``plan_counts`` reads the launches since the last reset, as
    ``launch_counts`` does, so a served path's launches by plan sum to
    its launch counts."""
    from repro_torch.kernels import plan_counts, reset_launch_counts
    from repro_torch.kernels.tiled_matmul.ops import tiled_matmul
    reset_launch_counts()
    quant_act.plans["block 1x96 v8 p1"] += 3
    tiled_matmul.plans["wide"] += 1
    assert plan_counts() == {"quant_act": {"block 1x96 v8 p1": 3},
                             "quant_act_glu": {}, "tiled_matmul": {"wide": 1},
                             "fused_qkv": {}}
    reset_launch_counts()
    assert plan_counts() == {"quant_act": {}, "quant_act_glu": {},
                             "tiled_matmul": {}, "fused_qkv": {}}
