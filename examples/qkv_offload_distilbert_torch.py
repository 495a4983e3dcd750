"""The paper's integration scenario (§6.2) on the PyTorch/CUDA port:
DistilBERT Q/K/V offload, the twin of examples/qkv_offload_distilbert.py.

First the raw kernels on the paper's exact (64,768)x(768,3072) matrices:
the activation quantized per row (``quant_act``, kernel K1), the weights
per column, then the int8 tiled GEMM (``tiled_matmul``, kernel K2),
against the unquantized f32 oracle.  Then a DistilBERT-class model (the
smoke configuration) unquantized and with its projections in int8
(``quant_proj="w8a8"``: K1, the fused Q/K/V GEMM K3 and K2), reporting the
paper's metrics: mean prediction confidence and top-1 agreement.  On the
card the hand-written CUDA kernels run; on the CPU their plain versions.

    PYTHONPATH=src python examples/qkv_offload_distilbert_torch.py \
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.quantize_params import quantize_model_params
from repro_torch.core.quantized_linear import quantize_weight
from repro_torch.kernels.quant_act.ops import quant_act
from repro_torch.kernels.tiled_matmul.ops import tiled_matmul
from repro_torch.kernels.tiled_matmul.ref import matmul_f32_oracle
from repro_torch.models.transformer import Model, apply_model, init_model


def raw_kernel_demo(device="cuda") -> float:
    """The paper's GEMM in int8 against the f32 oracle; returns the rel-err
    ||int8 - f32|| / ||f32||."""
    dev = resolve_device(device)
    print("— raw kernels on the paper's GEMM (64,768)x(768,3072) —")
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(64, 768)).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(768, 3072)) * 0.05)
                         .astype(np.float32))
    a, b = a.to(dev), b.to(dev)
    out = tiled_matmul(quant_act(a), quantize_weight(b),
                       out_dtype=torch.float32)
    ref = matmul_f32_oracle(a, b)
    rel = (torch.linalg.norm(out - ref) / torch.linalg.norm(ref)).item()
    print(f"  int8 (K1 -> K2 on {dev.type}) vs fp32 oracle rel-err: "
          f"{rel:.4f}")
    return rel


def model_demo(device="cuda", model: Model | None = None,
               tokens: torch.Tensor | None = None) -> dict:
    """The smoke DistilBERT-class model in f32, unquantized and under w8a8
    with fused Q/K/V: mean top-1 confidence of each and their top-1
    agreement.  ``model`` (f32 master weights) and ``tokens`` (4, 64)
    default to ones drawn from seeded generators."""
    dev = resolve_device(device)
    print("— DistilBERT-class model with offloaded Q/K/V —")
    cfg = get_smoke_config("distilbert_paper").replace(quant_proj="none",
                                                       dtype="float32")
    full = get_config("distilbert_paper")
    print(f"  full config: {full.n_layers}L d={full.d_model} "
          f"heads={full.n_heads} (paper's integration target)")
    if model is None:
        model = init_model(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    if tokens is None:
        tokens = torch.randint(0, cfg.vocab_size, (4, 64),
                               generator=torch.Generator().manual_seed(1))
    model, tokens = model.to(dev), tokens.to(dev)
    with torch.inference_mode():
        fp_logits, _, _ = apply_model(model, tokens, cfg)
        q_logits, _, _ = apply_model(quantize_model_params(model), tokens,
                                     cfg.replace(quant_proj="w8a8"))
    fp_conf = torch.softmax(fp_logits, -1).amax(-1).mean().item()
    q_conf = torch.softmax(q_logits, -1).amax(-1).mean().item()
    agree = (fp_logits.argmax(-1) == q_logits.argmax(-1)).float().mean().item()
    print(f"  mean confidence fp32 {fp_conf:.4f} vs int8 {q_conf:.4f} "
          "(paper: 99.95% vs 99.80%)")
    print(f"  top-1 prediction agreement: {agree:.3f}")
    return {"fp_conf": fp_conf, "q_conf": q_conf, "agree": agree}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    raw_kernel_demo(args.device)
    model_demo(args.device)


if __name__ == "__main__":
    main()
