"""End-to-end training driver on the PyTorch/CUDA port, the twin of
examples/train_lm.py: a ~100M-parameter LM, synthetic data, checkpoints.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300 \
        [--device cuda|cpu] [--inject-failure]

The full loop: the SyntheticLM pipeline, the microbatched train step
(two microbatches), async checkpoints, the straggler monitor and, with
--inject-failure, the checkpoint/restart path (a failure injected at the
middle step, the run restored from its last checkpoint).  On the card the
CUDA kernels run (K5 and its backward where a sequence reaches
``blockwise_attn_threshold``); on the CPU their plain versions.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_model
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.runtime.failures import FailureOracle, run_with_restarts
from repro_torch.training.train_step import (TrainState, make_train_step,
                                             trainable)
from repro_torch.training.trainer import Trainer

CFG_100M = ModelConfig(
    name="repro-lm-100m", family="dense",
    n_layers=12, d_model=768, vocab_size=32_000,
    n_heads=12, n_kv_heads=4, head_dim=64, d_ff=2048,
    ffn_type="swiglu", tie_embeddings=True, dtype="float32",
)


def main(argv=None, cfg: ModelConfig = CFG_100M):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--inject-failure", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def new_model():
        return init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                          device=dev)

    n = sum(t.numel() for t in trainable(new_model()).values())
    print(f"model: {cfg.name} ({n / 1e6:.0f}M params) on {dev}")

    opt = AdamW(learning_rate=warmup_cosine(3e-4, 50, args.steps))
    step_fn = make_train_step(cfg, opt, microbatches=2)
    data = SyntheticLM(cfg.vocab_size, batch=args.batch, seq_len=args.seq,
                       seed=0, device=dev)
    oracle = (FailureOracle(fail_at_steps=(args.steps // 2,))
              if args.inject_failure else None)

    def make_trainer():
        return Trainer(state=TrainState.create(new_model(), opt),
                       step_fn=step_fn, data=data, ckpt_dir=args.ckpt_dir,
                       ckpt_every=50, oracle=oracle, log_every=10)

    state, restarts, history = run_with_restarts(
        make_trainer, total_steps=args.steps, ckpt_dir=args.ckpt_dir)
    print(f"finished at step {int(state.step)} after {restarts} restarts")
    for item in history:
        if isinstance(item, tuple) and item[0] == "restart":
            print(f"  [restarted from failure at step {item[1]}]")
        else:
            s, m = item
            print(f"  step {s:4d}  loss {m['loss']:.4f}  "
                  f"gnorm {m['grad_norm']:.2f}  lr {m['lr']:.2e}")
    return state, restarts, history


if __name__ == "__main__":
    main()
