"""Port's quantization core and quant_act (K1) plain version vs the JAX
package, bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantization import quantize as jax_quantize
from repro.kernels.quant_act.ops import quant_act as jax_quant_act
from repro.kernels.quant_act.ref import quant_act_ref as jax_quant_act_ref
from repro_torch.core.quantization import dequantize, qmax_for_bits, quantize
from repro_torch.kernels.quant_act.ops import quant_act
from repro_torch.kernels.quant_act.ref import quant_act_ref


def _pair(shape, dtype, seed, zero_row=True):
    """The same values as a torch tensor and a jax array (f32 or bf16)."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 3
    if zero_row:
        x[(0,) * (len(shape) - 1)] = 0.0
    t = torch.from_numpy(x).to(dtype)
    j = jnp.asarray(t.float().numpy())          # exact: bf16 ⊂ f32
    if dtype == torch.bfloat16:
        j = j.astype(jnp.bfloat16)
    return t, j


def _assert_same(qt, qj):
    np.testing.assert_array_equal(qt.values.numpy(), np.asarray(qj.values))
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(qj.scale))
    assert qt.values.dtype == torch.int8
    assert qt.scale.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,axes", [
    ((37, 50), (0,)),            # per row (activations)
    ((50, 37), (1,)),            # per output channel (weights)
    ((13, 21), ()),              # per tensor
    ((3, 24, 40), (0, 2)),       # layer-stacked weights: per (layer, channel)
])
def test_quantize_matches_jax(shape, axes, dtype):
    t, j = _pair(shape, dtype, seed=len(shape) * 7 + len(axes))
    qt = quantize(t, channel_axes=axes)
    _assert_same(qt, jax_quantize(j, channel_axes=axes))
    assert qt.scale.shape == tuple(1 if i not in axes else n
                                   for i, n in enumerate(shape))


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_bits_and_dequantize(bits):
    t, j = _pair((16, 24), torch.float32, seed=bits)
    qt = quantize(t, channel_axes=(1,), bits=bits)
    _assert_same(qt, jax_quantize(j, channel_axes=(1,), bits=bits))
    assert int(qt.values.abs().max()) <= qmax_for_bits(bits)
    deq = dequantize(qt)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jax_quantize(j, channel_axes=(1,),
                                             bits=bits).dequantize()))
    with pytest.raises(ValueError):
        qmax_for_bits(9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 768), (5, 770), (1, 33)])
def test_quant_act_ref_matches_jax_ref(shape, dtype):
    t, j = _pair(shape, dtype, seed=shape[1])
    vt, st = quant_act_ref(t)
    vj, sj = jax_quant_act_ref(j)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    # the zero row quantizes to zeros with scale 1
    assert st[0, 0] == 1.0 and not vt[0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(24, 128), (7, 96)])
def test_quant_act_matches_pallas_interpret(shape, dtype):
    t, j = _pair(shape, dtype, seed=shape[0])
    qt = quant_act(t)                      # CPU tensor: the plain version
    qj = jax_quant_act(j, mode="pallas_interpret")
    np.testing.assert_array_equal(qt.values.numpy(), np.asarray(qj.values))
    # the interpreted Pallas kernel divides by qmax as a reciprocal multiply,
    # so its scale may sit 1 ulp off its own ref (tests/test_kernels.py holds
    # it to the same atol); the values stay bitwise
    np.testing.assert_allclose(qt.scale.numpy(), np.asarray(qj.scale),
                               atol=1e-8, rtol=0)


def test_quant_act_rounds_half_to_even():
    # x / scale lands exactly on .5 steps: 127 * (k + 0.5) / 127.5 ...
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]])
    v, s = quant_act_ref(x)
    assert s.item() == 1.0
    assert v.tolist() == [[127, 0, 2, 2, 0, -2]]
    vj, _ = jax_quant_act_ref(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(v.numpy(), np.asarray(vj))


@pytest.mark.parametrize("shape", [(50, 37), (3, 24, 40)])
def test_quantize_weight_k_major_matches_jax(shape):
    """Weights rest K-major (the (K, N) view of an (N, K)-contiguous copy),
    with the JAX package's values and per-channel scales."""
    from repro.core.quantized_linear import weight_channel_axes as jax_axes
    from repro_torch.core.quantized_linear import quantize_weight
    t, j = _pair(shape, torch.float32, seed=len(shape))
    qt = quantize_weight(t)
    _assert_same(qt, jax_quantize(j, channel_axes=jax_axes(j)))
    assert qt.values.transpose(-1, -2).is_contiguous()
    assert qt.values.stride()[-2:] == (1, shape[-2])


def test_quantize_linear_weights_stay_k_major_through_to_and_deepcopy():
    import copy

    from repro_torch.core.quantized_linear import init_linear, quantize_linear
    lin = quantize_linear(init_linear(torch.Generator().manual_seed(0), 48,
                                      80, use_bias=True))
    for moved in (lin, lin.to("cpu"), lin.to(torch.device("cpu")),
                  copy.deepcopy(lin), copy.deepcopy(lin).to("cpu")):
        values = moved.w_q.values
        assert values.shape == (48, 80) and values.stride() == (1, 48)
        assert torch.equal(values, lin.w_q.values)
    # the plain version takes the view as it is: the same product as on a
    # row-major copy, bit for bit
    from repro_torch.core.quantized_linear import apply_linear
    x = torch.randn((5, 48), generator=torch.Generator().manual_seed(1))
    row_major = quantize_linear(init_linear(torch.Generator().manual_seed(0),
                                            48, 80, use_bias=True))
    row_major.w_q_values = row_major.w_q_values.contiguous()
    assert torch.equal(apply_linear(lin, x, mode="w8a8"),
                       apply_linear(row_major, x, mode="w8a8"))


def test_tensor_to_keeps_k_major_strides():
    """``Tensor.to`` and ``deepcopy`` keep the strides of a dense view (the
    card's ``.to(device)`` takes the same preserve_format path)."""
    import copy
    v = torch.arange(6 * 10, dtype=torch.int8).reshape(10, 6).t()
    for w in (v.to(torch.int8), v.to("cpu", copy=True), copy.deepcopy(v),
              v.clone()):
        assert w.stride() == (1, 6) and torch.equal(w, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axes", [(0,), ()])
def test_fake_quantize_matches_jax_and_passes_gradients_through(dtype, axes):
    import jax

    from repro.core.quantization import fake_quantize as jax_fake_quantize
    from repro_torch.core.quantization import fake_quantize
    t, j = _pair((9, 16), dtype, seed=5)
    got = fake_quantize(t, channel_axes=axes)
    want = jax_fake_quantize(j, channel_axes=axes)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    x = t.float().requires_grad_()
    g = torch.autograd.grad((fake_quantize(x, channel_axes=axes) * 3).sum(),
                            x)[0]
    jg = jax.grad(lambda v: jnp.sum(3 * jax_fake_quantize(
        v, channel_axes=axes)))(jnp.asarray(x.detach().numpy()))
    assert torch.equal(g, torch.full_like(x, 3.0))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


@pytest.mark.parametrize("momentum", [None, 0.9])
def test_calibrator_matches_jax(momentum):
    from repro.core.quantization import Calibrator as JaxCalibrator
    from repro_torch.core.quantization import Calibrator
    cal, jcal = Calibrator(momentum=momentum), JaxCalibrator(
        momentum=momentum)
    with pytest.raises(ValueError):
        cal.scale
    for seed in range(4):
        t, j = _pair((6, 10), torch.float32, seed=seed, zero_row=False)
        cal.observe(t * (seed + 1))
        jcal.observe(j * (seed + 1))
    assert cal.scale == jcal.scale
    t, j = _pair((5, 7), torch.float32, seed=9)
    _assert_same(cal.quantize(t * 4), jcal.quantize(j * 4))
