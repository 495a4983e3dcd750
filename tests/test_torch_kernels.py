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
from repro_torch.kernels.fused_qkv.ops import fused_qkv
from repro_torch.kernels.tiled_matmul.ops import tiled_matmul
from repro_torch.kernels.tiled_matmul.ref import int_matmul_exact

_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _operands(m, k, ns, seed):
    """Per-row quantized A and per-channel quantized B_j in both packages."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, k)).astype(np.float32)
    bs = [(rng.normal(size=(k, n)) * 0.05).astype(np.float32) for n in ns]
    ta = quantize(torch.from_numpy(a), channel_axes=(0,))
    ja = jax_quantize(jnp.asarray(a), channel_axes=(0,))
    tb = [quantize(torch.from_numpy(b), channel_axes=(1,)) for b in bs]
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

