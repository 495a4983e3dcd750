"""Trainer: the production loop — step, checkpoints, fault hooks."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

from repro_torch.checkpoint.store import AsyncCheckpointer, restore_checkpoint
from repro_torch.runtime.failures import FailureOracle
from repro_torch.runtime.stragglers import StragglerMonitor


@dataclasses.dataclass
class Trainer:
    state: Any
    step_fn: Callable                      # (state, batch) -> (state, metrics)
    data: Iterable                         # yields batches
    ckpt_dir: str
    ckpt_every: int = 50
    oracle: FailureOracle | None = None
    log_every: int = 10
    monitor: StragglerMonitor = dataclasses.field(
        default_factory=StragglerMonitor)

    def __post_init__(self):
        self._ckpt = AsyncCheckpointer(self.ckpt_dir)
        self._data_it = iter(self.data)

    def save(self, step: int, state):
        self._ckpt.save(step, state)

    def restore(self, step: int):
        return restore_checkpoint(self.ckpt_dir, step, like=self.state)

    def run(self, from_step: int, to_step: int):
        """Steps ``from_step`` .. ``to_step`` - 1; returns (the step
        reached, [(step, metrics as floats)] every ``log_every`` steps and
        at the end).  A checkpoint lands every ``ckpt_every`` steps and at
        the end."""
        history = []
        # fast-forward data to stay deterministic across restarts
        if hasattr(self.data, "batch_at"):
            get_batch = self.data.batch_at
        else:
            get_batch = lambda _: next(self._data_it)  # noqa: E731
        step = from_step
        while step < to_step:
            batch = get_batch(step)
            if self.oracle is not None:
                self.oracle.maybe_fail(step)
            self.monitor.step_start()
            self.state, metrics = self.step_fn(self.state, batch)
            # reading the metrics waits for the step's device work
            m = {k: float(v) for k, v in metrics.items()}
            step += 1
            self.monitor.step_end(step)
            if step % self.log_every == 0 or step == to_step:
                history.append((step, m))
            if step % self.ckpt_every == 0 or step == to_step:
                self.save(step, self.state)
        self._ckpt.wait()
        return step, history
