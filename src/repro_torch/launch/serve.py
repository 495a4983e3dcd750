"""Quantized serving launcher (the paper's deployment, batched).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch distilbert_paper \
        --batch 4 --prompt-len 64 --tokens 32 [--quant w8a8|w8|none] \
        [--device cuda|cpu] [--smoke]

Random weights from a seeded generator → offline weight quantization
(block by block as drawn: decoder blocks with their MoE experts, Mamba2
blocks and the hybrid family's shared block) → one-pass prefill → batched
greedy decode, reporting per-phase latency and tokens/s.  The dense, MoE,
SSM (``mamba2_370m``), hybrid (``zamba2_7b``, these two on their dense
slot state) and vision (``phi3_vision_4_2b``, text-only) families run.
An encoder-decoder (``seamless_m4t_medium``) is refused: it needs frames
encoded into memory, which this launcher does not take; drive it with
``encode`` and ``prefill`` / ``greedy_decode(memory=)``
(``repro_torch.models.transformer``, ``repro_torch.serving.engine``).
``--device cuda`` (the default) needs a card and runs the CUDA kernels;
``--device cpu`` runs their plain PyTorch versions.
"""
import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_5_3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--quant", default="w8a8",
                    choices=["none", "w8", "w8a8"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.quantize_params import quantize_model_params
    from repro_torch.models.transformer import init_model
    from repro_torch.serving.cache import init_cache
    from repro_torch.serving.engine import greedy_decode, prefill

    dev = resolve_device(args.device)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch)).replace(quant_proj=args.quant)
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name} is an encoder-decoder: this launcher takes no "
            "frames; encode them with encode(model, frames, cfg) and serve "
            "with prefill / greedy_decode(memory=)")
    # quantized one block at a time as drawn (the MoE family's experts too,
    # as the JAX launcher does; Mamba2 blocks and the shared block alike),
    # so the f32 master is never whole
    def quantize(block):
        return quantize_model_params(block, quantize_experts=cfg.is_moe)

    model = init_model(torch.Generator().manual_seed(0),
                       cfg.replace(quant_proj="none"), device="cpu",
                       each_block=None if args.quant == "none" else quantize
                       ).to(dev)
    cache = init_cache(cfg, args.batch, args.prompt_len + args.tokens,
                       dtype=cfg.activation_dtype, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(1)).to(dev)
    lens = torch.full((args.batch,), args.prompt_len, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = prefill(model, cache, prompts, lens, cfg)
        first = torch.argmax(logits, dim=-1)[:, None]
        sync()
        t_prefill = time.perf_counter() - t0

        t0 = time.perf_counter()
        toks, cache = greedy_decode(model, cache, first, lens, args.tokens,
                                    cfg)
        sync()
        t_decode = time.perf_counter() - t0

    tps = args.batch * args.tokens / t_decode
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"arch={cfg.name} quant={args.quant} batch={args.batch} "
          f"device={where}")
    print(f"prefill: {t_prefill:.4f}s   decode: {t_decode:.4f}s "
          f"({tps:.1f} tok/s)")
    print("sample:", toks[0].tolist()[:16])


if __name__ == "__main__":
    main()
