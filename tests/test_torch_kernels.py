"""Port's tiled_matmul (K2) and fused_qkv (K3) plain versions vs the JAX
package's oracles and Pallas kernels (interpret mode)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantization import quantize as jax_quantize
from repro.kernels.fused_qkv.ops import fused_qkv as jax_fused_qkv
from repro.kernels.tiled_matmul.ops import tiled_matmul as jax_tiled_matmul
from repro_torch.core.quantization import quantize
from repro_torch.core.quantized_linear import quantize_weight
from repro_torch.kernels.fused_qkv.ops import fused_qkv
from repro_torch.kernels.tiled_matmul.ops import (MAX_K, GemmPlan,
                                                  check_plan, gemm_plan,
                                                  tiled_matmul)
from repro_torch.kernels.tiled_matmul.ref import int_matmul_exact

_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _operands(m, k, ns, seed):
    """Per-row quantized A and per-channel quantized B_j in both packages,
    the port's B_j K-major as the model stores them."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, k)).astype(np.float32)
    bs = [(rng.normal(size=(k, n)) * 0.05).astype(np.float32) for n in ns]
    ta = quantize(torch.from_numpy(a), channel_axes=(0,))
    ja = jax_quantize(jnp.asarray(a), channel_axes=(0,))
    tb = [quantize_weight(torch.from_numpy(b)) for b in bs]
    jb = [jax_quantize(jnp.asarray(b), channel_axes=(1,)) for b in bs]
    return ta, ja, tb, jb


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(
        x.astype(jnp.float32))


RAGGED = [(5, 70, 100), (33, 130, 17), (1, 64, 64), (64, 96, 80)]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", RAGGED)
@pytest.mark.parametrize("jax_mode", ["ref", "pallas_interpret"])
def test_tiled_matmul_bitwise_without_bias(m, k, n, out_dtype, jax_mode):
    ta, ja, (tb,), (jb,) = _operands(m, k, [n], seed=m * k + n)
    out = tiled_matmul(ta, tb, out_dtype=out_dtype)
    ref = jax_tiled_matmul(ja, jb, out_dtype=_DT[out_dtype], mode=jax_mode)
    assert out.dtype == out_dtype and out.shape == (m, n)
    np.testing.assert_array_equal(_np(out), _np(ref))


@pytest.mark.parametrize("m,k,n", RAGGED)
@pytest.mark.parametrize("jax_mode", ["ref", "pallas_interpret"])
def test_tiled_matmul_bias_within_one_ulp(m, k, n, jax_mode):
    ta, ja, (tb,), (jb,) = _operands(m, k, [n], seed=m + k + n)
    bias = np.random.default_rng(n).normal(size=(n,)).astype(np.float32)
    out = tiled_matmul(ta, tb, torch.from_numpy(bias), out_dtype=torch.float32)
    ref = jax_tiled_matmul(ja, jb, jnp.asarray(bias), out_dtype=jnp.float32,
                           mode=jax_mode)
    # the JAX side may contract the bias add into an FMA: <= 1 ulp
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("with_bias", [False, True])
def test_tiled_matmul_paper_gemm(with_bias):
    """The paper's (64, 768) x (768, 3072) GEMM against tiled_matmul_ref."""
    ta, ja, (tb,), (jb,) = _operands(64, 768, [3072], seed=6)
    bias = (np.random.default_rng(1).normal(size=(3072,)).astype(np.float32)
            if with_bias else None)
    out = tiled_matmul(ta, tb, None if bias is None else torch.from_numpy(bias),
                       out_dtype=torch.float32)
    ref = jax_tiled_matmul(ja, jb, None if bias is None else jnp.asarray(bias),
                           out_dtype=jnp.float32, mode="ref")
    if with_bias:
        np.testing.assert_allclose(_np(out), _np(ref), atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(_np(out), _np(ref))


def test_int_matmul_exact_at_the_int32_extreme():
    """|acc| = 127^2 * 3072 is past f32's exact range, inside f64's."""
    a = torch.full((4, 3072), 127, dtype=torch.int8)
    b = torch.full((3072, 5), -127, dtype=torch.int8)
    b[0, 0] = 126
    acc = int_matmul_exact(a, b)
    assert acc.dtype == torch.int32
    assert acc[0, 1].item() == -127 * 127 * 3072
    assert acc[0, 0].item() == -127 * 127 * 3071 + 127 * 126


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,nq,nkv", [
    (24, 64, 64, 64),            # MHA
    (9, 96, 128, 32),            # GQA: K/V narrower than Q
    (3, 70, 50, 50),             # ragged everything
])
@pytest.mark.parametrize("jax_mode", ["ref", "pallas_interpret"])
def test_fused_qkv_bitwise(m, k, nq, nkv, out_dtype, jax_mode):
    ta, ja, tws, jws = _operands(m, k, [nq, nkv, nkv], seed=m * nq + nkv)
    outs = fused_qkv(ta, *tws, out_dtype=out_dtype)
    refs = jax_fused_qkv(ja, *jws, out_dtype=_DT[out_dtype], mode=jax_mode)
    for o, r, n in zip(outs, refs, (nq, nkv, nkv)):
        assert o.shape == (m, n) and o.dtype == out_dtype
        np.testing.assert_array_equal(_np(o), _np(r))


def test_fused_qkv_rejects_kv_wider_than_q():
    ta, _, tws, _ = _operands(4, 32, [16, 32, 32], seed=0)
    with pytest.raises(ValueError):
        fused_qkv(ta, *tws)



def test_operands_are_k_major():
    _, _, (tb,), _ = _operands(5, 70, [100], seed=0)
    assert tb.values.shape == (70, 100) and tb.values.stride() == (1, 70)


# the plan of every K2 / K3 call of the served paths: distilbert's layer at
# prefill (M=256) and decode (M=4), qwen2.5-3b's at decode (4), verify
# (20) and an 8192-token prefill (wo, gate/up, down; fused QKV)
SERVED_PLANS = [
    (256, [768, 768, 768], 768, GemmPlan("swap", 64, 1, 6)),
    (256, [768], 768, GemmPlan("swap", 64, 1, 6)),
    (256, [3072], 768, GemmPlan("swap", 64, 1, 6)),
    (256, [768], 3072, GemmPlan("swap", 64, 5, 5)),
    (4, [768, 768, 768], 768, GemmPlan("swap", 8, 1, 6)),
    (4, [768], 3072, GemmPlan("swap", 8, 6, 4)),
    (4, [2048, 256, 256], 2048, GemmPlan("swap", 8, 4, 4)),
    (4, [2048], 2048, GemmPlan("swap", 8, 4, 4)),
    (4, [11008], 2048, GemmPlan("swap", 8, 1, 16)),
    (4, [2048], 11008, GemmPlan("swap", 8, 8, 11)),
    (20, [2048, 256, 256], 2048, GemmPlan("swap", 32, 4, 4)),
    (20, [11008], 2048, GemmPlan("swap", 32, 1, 16)),
    (8192, [2048, 256, 256], 2048, GemmPlan("wide", 256, 1, 16)),
    (8192, [2048], 2048, GemmPlan("wide", 256, 1, 16)),
    (8192, [11008], 2048, GemmPlan("wide", 256, 1, 16)),
    (8192, [2048], 11008, GemmPlan("wide", 256, 1, 86)),
]


@pytest.mark.parametrize("m,ns,k,want", SERVED_PLANS,
                         ids=[f"{m}x{k}x{'|'.join(map(str, ns))}"
                              for m, ns, k, _ in SERVED_PLANS])
def test_gemm_plan_served_shapes(m, ns, k, want):
    assert gemm_plan(m, ns, k, aligned=True) == want


@pytest.mark.parametrize("m,ns,k,aligned", [
    (5, [100], 770, True),           # K % 16: TMA needs 16-byte row strides
    (3, [50, 20, 20], 70, True),
    (256, [768], 768, False),        # a base off 16-byte alignment
    (0, [768], 768, True),
])
def test_gemm_plan_takes_the_general_tile_where_tma_cannot(m, ns, k, aligned):
    assert gemm_plan(m, ns, k, aligned) == GemmPlan("general", 0, 1, 0)


@pytest.mark.parametrize("m", [1, 4, 8, 9, 20, 33, 64, 65, 129, 256, 512,
                               513, 8192])
@pytest.mark.parametrize("k", [16, 208, 768, 2048, 11008])
def test_gemm_plan_splits_cover_k(m, k):
    """Every split gets at least one k-step, the last ends at K; the wide
    variant takes M > 512 and M > 64 where its tiles fill half the SMs,
    and never splits; the swap one splits only where its tiles leave
    three quarters of the SMs idle, and pads M to the smallest of
    8/16/32/64 that holds it (tiles of 64 rows past 64)."""
    ns = [2048, 256, 256]
    plan = gemm_plan(m, ns, k, aligned=True)
    nk = -(-k // 128)
    assert (plan.split - 1) * plan.chunk < nk <= plan.split * plan.chunk
    wide_tiles = -(-m // 128) * (8 + 1 + 1)
    assert plan.variant == ("wide" if m > 512 or (m > 64 and wide_tiles >= 66)
                            else "swap")
    if plan.variant == "wide":
        assert plan.split == 1
    else:
        assert plan.cols == min(c for c in (8, 16, 32, 64) if c >= min(m, 64))
        tiles = -(-m // plan.cols) * sum(-(-n // 128) for n in ns)
        assert plan.split == 1 or (tiles <= 33 and plan.split * tiles <= 132)


@pytest.mark.parametrize("m,ns,k,_", SERVED_PLANS,
                         ids=[f"{m}x{k}x{'|'.join(map(str, ns))}"
                              for m, ns, k, _ in SERVED_PLANS])
def test_check_plan_takes_gemm_plans_own(m, ns, k, _):
    check_plan(gemm_plan(m, ns, k, aligned=True), m, ns, k, aligned=True)


# plans the kernel would run to a wrong product, at K = 2048 (16 k-steps)
# unless noted: splits that miss k-steps, an empty last split, a wide
# split, widths no variant is built for, TMA on what it cannot read
MISFIT_PLANS = [
    (GemmPlan("wide", 256, 1, 4), 2048, True),      # 4 of 16 k-steps
    (GemmPlan("swap", 8, 2, 1), 2048, True),        # 2 of 16
    (GemmPlan("swap", 8, 1, 0), 2048, True),        # none: bias alone
    (GemmPlan("swap", 8, 4, 6), 2048, True),        # last split empty
    (GemmPlan("swap", 8, 0, 16), 2048, True),
    (GemmPlan("wide", 256, 2, 8), 2048, True),      # the wide tile unsplit
    (GemmPlan("wide", 128, 1, 16), 2048, True),
    (GemmPlan("swap", 24, 1, 16), 2048, True),
    (GemmPlan("swap", 256, 1, 16), 2048, True),
    (GemmPlan("tiled", 64, 1, 16), 2048, True),
    (GemmPlan("swap", 8, 1, 7), 770, True),         # K % 16
    (GemmPlan("swap", 8, 1, 16), 2048, False),      # a base off 16 bytes
    (GemmPlan("general", 0, 2, 8), 2048, True),
]


@pytest.mark.parametrize("plan,k,aligned", MISFIT_PLANS,
                         ids=[f"{p.variant}{p.cols}-{p.split}x{p.chunk}-k{k}"
                              f"{'' if al else '-unaligned'}"
                              for p, k, al in MISFIT_PLANS])
def test_check_plan_refuses_plans_that_do_not_fit(plan, k, aligned):
    with pytest.raises(ValueError, match="does not fit"):
        check_plan(plan, 4, (2048,), k, aligned)


def test_gemm_wrappers_refuse_depths_that_could_overflow():
    a = quantize(torch.ones((1, MAX_K + 1)), channel_axes=(0,))
    b = quantize_weight(torch.ones((MAX_K + 1, 2)))
    with pytest.raises(ValueError, match="overflow"):
        tiled_matmul(a, b)
    with pytest.raises(ValueError, match="overflow"):
        fused_qkv(a, b, b, b)
