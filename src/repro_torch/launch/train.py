"""Training launcher, the twin of the JAX package's ``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_5_3b \
        --steps 100 --batch 16 --seq 256 [--smoke] [--device cuda|cpu] \
        [--ckpt-dir DIR] [--compress-grads] [--microbatches N]

Random f32 master weights drawn from a seeded generator on the device,
the ZeRO-1 state for bf16 configs (a bf16 compute copy beside f32 master
weights and AdamW moments), ``warmup_cosine`` AdamW and the Trainer on the
SyntheticLM pipeline, with a checkpoint every ``--ckpt-every`` steps and
at the end.  One device: ``--devices``, ``--data-par`` and ``--model-par``
above 1 are refused: sharded training is ROADMAP queue 1, item 13's
training half (the port's meshes, ``launch/mesh.py``, serve so far).
``--device cuda`` (the default) needs a card and runs the CUDA kernels
(K5 and its backward at sequences of ``blockwise_attn_threshold`` tokens
or more); ``--device cpu`` runs their plain versions.
"""
import argparse
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser(
        epilog="A checkpoint holds the whole state: qwen2.5-3b's ZeRO-1 "
               "state (bf16 compute copy, f32 master, mu and nu) is ~43 GB "
               "on disk, its bf16 leaves written as f32.")
    ap.add_argument("--arch", default="qwen2_5_3b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--data-par", type=int, default=None)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--dtype", default=None, choices=[None, "float32",
                                                      "bfloat16"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    for flag in ("devices", "data_par", "model_par"):
        if (getattr(args, flag) or 1) > 1:
            raise SystemExit(
                f"--{flag.replace('_', '-')} {getattr(args, flag)}: the port "
                "trains on one device; sharded training is ROADMAP queue 1, "
                "item 13's training half (launch/mesh.py serves so far)")

    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.transformer import init_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.runtime.compression import GradCompressor
    from repro_torch.training.train_step import (TrainState, make_train_step,
                                                 trainable)
    from repro_torch.training.trainer import Trainer

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    print(f"arch={cfg.name} device={dev} dtype={cfg.dtype}")

    model = init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                       device=dev)
    opt = AdamW(learning_rate=warmup_cosine(args.lr, 20, args.steps))
    zero1 = cfg.dtype == "bfloat16"
    state = TrainState.create(model, opt, zero1=zero1)

    compressor = None
    if args.compress_grads:
        gc = GradCompressor()
        residual = {"r": gc.init_residual(state.master if zero1
                                          else trainable(model))}
        generator = torch.Generator(device=dev).manual_seed(7)

        def compressor(grads):
            wire, residual["r"] = gc.compress_decompress(
                grads, residual["r"], generator)
            return wire

    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches,
                              compressor=compressor)
    data = SyntheticLM(cfg.vocab_size, batch=args.batch, seq_len=args.seq,
                       seed=0, frontend=cfg.frontend,
                       frontend_len=cfg.frontend_len, d_model=cfg.d_model,
                       device=dev)
    trainer = Trainer(state=state, step_fn=step_fn, data=data,
                      ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    final_step, history = trainer.run(0, args.steps)
    for s, m in history[-5:]:
        print(f"step {s:5d}  loss {m['loss']:.4f}  gnorm "
              f"{m['grad_norm']:.2f}")
    print(f"done at step {final_step}; checkpoints in {args.ckpt_dir}")
    return history


if __name__ == "__main__":
    main()
