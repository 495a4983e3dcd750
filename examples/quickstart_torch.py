"""Quickstart on the PyTorch/CUDA port: build a model, quantize it (the
paper's technique), decode.  The twin of examples/quickstart.py.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]

On the card the projections run the hand-written int8 kernels (K1 quantizes
the activations, K3 the fused Q/K/V GEMM, K2 the others); on the CPU their
plain PyTorch versions.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.core.quantize_params import quantize_model_params
from repro_torch.models.transformer import Model, apply_model, init_model
from repro_torch.serving.cache import init_cache
from repro_torch.serving.engine import greedy_decode


def main(argv=None, model: Model | None = None,
         tokens: torch.Tensor | None = None, cfg=None) -> dict:
    """Returns the fp-vs-int8 logits rel-err, both logits and the greedy
    tokens.  ``model`` (unquantized) and ``tokens`` (2, 16) default to ones
    drawn from seeded generators; ``cfg`` to qwen2.5-3b's smoke config."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # any assigned arch works (full configs are for the card's paths; smoke
    # configs run anywhere)
    cfg = cfg or get_smoke_config("qwen2_5_3b")
    print(f"arch={cfg.name}  layers={cfg.n_layers}  d_model={cfg.d_model}")

    if model is None:
        model = init_model(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    if tokens is None:
        tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                               generator=torch.Generator().manual_seed(1))
    model, tokens = model.to(dev), tokens.to(dev)

    # --- the paper's technique: replace projection GEMMs with int8 ---
    qmodel = quantize_model_params(model)
    qcfg = cfg.replace(quant_proj="w8a8")
    with torch.inference_mode():
        fp_logits, _, _ = apply_model(model, tokens, cfg)
        q_logits, _, _ = apply_model(qmodel, tokens, qcfg)
        rel = (torch.linalg.norm((q_logits - fp_logits).float())
               / torch.linalg.norm(fp_logits.float())).item()
        print(f"fp32-vs-int8 logits rel err: {rel:.4f} "
              "(paper: near-lossless)")

        # --- serve a few tokens with the quantized model ---
        cache = init_cache(qcfg, 2, 32, device=dev)
        out, _ = greedy_decode(qmodel, cache, tokens[:, :1], 0, 8, qcfg)
    print("greedy decode:", out.tolist())
    return {"rel": rel, "fp_logits": fp_logits, "q_logits": q_logits,
            "tokens": out}


if __name__ == "__main__":
    main()
