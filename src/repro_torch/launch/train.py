"""Training launcher, the twin of the JAX package's ``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_5_3b \
        --steps 100 --batch 16 --seq 256 [--smoke] [--device cuda|cpu] \
        [--ckpt-dir DIR] [--compress-grads] [--microbatches N] \
        [--data-par D --model-par M --backend gloo|nccl] [--devices N]

Random f32 master weights drawn from a seeded generator, the ZeRO-1 state
for bf16 configs (a bf16 compute copy beside f32 master weights and AdamW
moments), ``warmup_cosine`` AdamW and the Trainer on the SyntheticLM
pipeline, with a checkpoint every ``--ckpt-every`` steps and at the end.

``--data-par`` and ``--model-par`` above 1 (or ``--devices``, whose ranks
go to ``data`` after ``--model-par``, as the JAX launcher's host mesh
takes them) train over a ``("data", "model")`` mesh, one process a rank
(``launch/mesh.py``): ZeRO-1 over ``data``, tensor parallelism over
``model`` (``training/train_step.py``).  Every rank draws the whole model
from the same seed and keeps its share (``bridge.shard_train_state``),
and takes its rows of the global batch of ``--batch`` sequences.  The
backend is explicit: ``--backend gloo`` on the CPU and for ranks that
share one card (``cuda:0``), ``nccl`` for one card a rank
(``cuda:{rank}``).  Rank 0 prints and writes the checkpoints, in the
whole-state format one device reads too.

``--device cuda`` (the default) needs a card and runs the CUDA kernels
(K5 and its backward at sequences of ``blockwise_attn_threshold`` tokens
or more); ``--device cpu`` runs their plain versions.
"""
import argparse
import math
import os
import tempfile


def _parser():
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
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="needed with more than one rank: gloo (the CPU, or "
                         "ranks sharing one card) or nccl (a card a rank)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 gradient compression with error feedback "
                         "(stochastic rounding, seed 7) on the reduced "
                         "gradient before AdamW, on any mesh: each rank "
                         "compresses its blocks as the whole leaves")
    ap.add_argument("--dtype", default=None, choices=[None, "float32",
                                                      "bfloat16"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def mesh_shape(args) -> tuple[int, int]:
    """(data, model) of the flags: ``--devices`` ranks in all, ``data``
    taking what ``--model-par`` leaves unless ``--data-par`` says."""
    model = args.model_par
    data = args.data_par
    if data is None:
        data = (args.devices or model) // model
    if args.devices is not None and data * model != args.devices:
        raise SystemExit(f"--devices {args.devices} is not --data-par "
                         f"{data} x --model-par {model}")
    if data < 1 or model < 1:
        raise SystemExit(f"a mesh of {data} x {model} ranks")
    return data, model


def _train(mesh, args):
    """One rank's run (the only one without a mesh): returns the
    history."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.bridge import shard_train_state
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.transformer import init_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.runtime.compression import GradCompressor
    from repro_torch.training.train_step import (TrainState, make_train_step,
                                                 trainable)
    from repro_torch.training.trainer import Trainer

    dev = mesh.device if mesh is not None else resolve_device(args.device)
    lead = mesh is None or mesh.global_rank == 0
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    if lead:
        shape = "1" if mesh is None else mesh.shape
        print(f"arch={cfg.name} device={dev} dtype={cfg.dtype} mesh={shape}")

    model = init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                       device=dev)
    opt = AdamW(learning_rate=warmup_cosine(args.lr, 20, args.steps))
    zero1 = cfg.dtype == "bfloat16"
    if mesh is None:
        state = TrainState.create(model, opt, zero1=zero1)
    else:
        state = shard_train_state(model, opt, mesh, zero1=zero1)

    compressor = None
    if args.compress_grads:
        gc = GradCompressor()
        residual = {"r": gc.init_residual(state.master if zero1
                                          else trainable(model))}
        generator = torch.Generator(device=dev).manual_seed(7)
        specs = None if mesh is None else state.placement.grad_specs(zero1)

        def compressor(grads):
            wire, residual["r"] = gc.compress_decompress(
                grads, residual["r"], generator, mesh=mesh,
                specs=specs)
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
    if lead:
        for s, m in history[-5:]:
            print(f"step {s:5d}  loss {m['loss']:.4f}  gnorm "
                  f"{m['grad_norm']:.2f}")
        print(f"done at step {final_step}; checkpoints in {args.ckpt_dir}",
              flush=True)
    return history


def main(argv=None):
    args = _parser().parse_args(argv)
    data, model = mesh_shape(args)
    world = data * model
    if world == 1:
        return _train(None, args)
    if args.backend is None:
        raise SystemExit(f"a mesh of {data} x {model} ranks needs --backend "
                         "(gloo: the CPU or ranks sharing one card; nccl: a "
                         "card a rank)")
    from repro_torch.launch.mesh import spawn_ranks
    if args.device == "cpu":
        device = "cpu"
    else:
        device = "cuda:{rank}" if args.backend == "nccl" else "cuda:0"
    runs = spawn_ranks(_train, world, data=data, backend=args.backend,
                       device=device, args=(args,), timeout=math.inf)
    return runs[0]


if __name__ == "__main__":
    main()
