"""Synthetic LM data pipeline: deterministic, sharded, prefetching.

Production shape without external datasets (offline container): a zipfian
token source with local n-gram structure (so the model has something real
to learn), deterministic in (seed, step, host), sliced per host for
multi-host training, with background prefetch.

The JAX package's numpy generator, draw for draw, so a batch is bitwise
the JAX package's for the same (seed, step, host_index); the arrays then
become tensors on the chosen ``device`` (int32 tokens, f32 frontend
embeddings).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch import resolve_device


class SyntheticLM:
    """Deterministic synthetic LM batches.

    Each batch: {"inputs": (B, S) int32, "targets": (B, S) int32} where
    targets are inputs shifted by one (next-token prediction).  Tokens
    follow a zipfian marginal with a repetition/copy structure: spans are
    repeated at offsets so that in-context copying is learnable.
    """

    def __init__(self, vocab_size: int, batch: int, seq_len: int, *,
                 seed: int = 0, host_index: int = 0, host_count: int = 1,
                 frontend: str | None = None, frontend_len: int = 0,
                 d_model: int = 0, device="cuda"):
        assert batch % host_count == 0
        self.device = resolve_device(device)
        self.vocab = vocab_size
        self.global_batch = batch
        self.local_batch = batch // host_count
        self.seq = seq_len
        self.seed = seed
        self.host_index = host_index
        self.frontend = frontend
        self.frontend_len = frontend_len
        self.d_model = d_model

    def batch_at(self, step: int) -> dict:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.numpy_batch_at(step).items()}

    def numpy_batch_at(self, step: int) -> dict:
        """The batch of ``step`` as numpy arrays."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4096 + self.host_index)
        b, s = self.local_batch, self.seq + 1
        # zipfian marginal, clipped to vocab
        toks = rng.zipf(1.3, size=(b, s)).astype(np.int64)
        toks = (toks - 1) % self.vocab
        # inject copy structure: repeat a random span once per row
        span = max(4, s // 16)
        src = rng.integers(0, s - 2 * span, size=b)
        dst = np.minimum(src + span + rng.integers(0, span, size=b),
                         s - span)
        for i in range(b):
            toks[i, dst[i]:dst[i] + span] = toks[i, src[i]:src[i] + span]
        batch = {"inputs": toks[:, :-1].astype(np.int32),
                 "targets": toks[:, 1:].astype(np.int32)}
        if self.frontend == "vision":
            batch["frontend_embeds"] = rng.standard_normal(
                (b, self.frontend_len, self.d_model)).astype(np.float32)
        elif self.frontend == "audio":
            batch["encoder_frames"] = rng.standard_normal(
                (b, self.seq, self.d_model)).astype(np.float32)
        return batch

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch (double buffering — the data-pipeline
    analogue of the paper's ping-pong buffers, §8)."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        for item in self._it:
            self._q.put(item)

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()
