"""The port's CUDA kernels against their plain versions, on the card.

Run on a machine with an H100:  python -m pytest -m gpu tests/test_torch_gpu.py
Without a card every test here skips (the card is checked in a fixture).
"""
import pytest
import torch

from repro_torch.core.quantization import quantize
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.fused_qkv import ref as fused_ref
from repro_torch.kernels.fused_qkv.ops import fused_qkv
from repro_torch.kernels.quant_act import ref as quant_ref
from repro_torch.kernels.quant_act.ops import quant_act
from repro_torch.kernels.tiled_matmul import ref as matmul_ref
from repro_torch.kernels.tiled_matmul.ops import tiled_matmul

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _randn(shape, seed, dev, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dev)


def _operands(m, k, ns, dev, seed=0):
    a = quantize(_randn((m, k), seed, dev), channel_axes=(0,))
    ws = [quantize(_randn((k, n), seed + 1 + i, dev, 0.05), channel_axes=(1,))
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


def test_cuda_tensors_never_take_the_plain_version(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(quant_ref, "quant_act_ref", refuse)
    monkeypatch.setattr(matmul_ref, "tiled_matmul_ref", refuse)
    monkeypatch.setattr(fused_ref, "fused_qkv_ref", refuse)
    reset_launch_counts()
    a = quant_act(_randn((8, 64), 0, cuda))
    _, ws = _operands(8, 64, [64, 32, 32], cuda)
    tiled_matmul(a, ws[0])
    fused_qkv(a, *ws)
    torch.cuda.synchronize()
    assert launch_counts() == {"quant_act": 1, "fused_qkv": 1,
                               "tiled_matmul": 1}


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    with pytest.raises(TypeError):
        quant_act(_randn((4, 8), 0, cuda).half())
    with pytest.raises(ValueError):
        quant_act(_randn((8, 4), 0, cuda).t())          # not contiguous
    a, (b,) = _operands(4, 32, [16], cuda)
    with pytest.raises(TypeError):
        tiled_matmul(a, b, out_dtype=torch.float16)
