"""Fault-tolerance driver: checkpoint/restart with failure injection.

The contract, as the JAX package's:

  1. every N steps an (async) checkpoint lands atomically (checkpoint/store)
  2. the Trainer detects failures (here: an injectable FailureOracle) and
     exits with a restartable status
  3. the launcher restarts the job; restore picks the latest complete
     checkpoint

``run_with_restarts`` is the single-process harness: it drives a Trainer
through injected failures and keeps the loss history across restarts.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.checkpoint.store import latest_step


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureOracle:
    """Deterministic failure schedule: step -> raise (once a step)."""
    fail_at_steps: tuple = ()
    _seen: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at_steps and step not in self._seen:
            self._seen.add(step)
            raise InjectedFailure(f"injected node failure at step {step}")


def run_with_restarts(make_trainer: Callable, total_steps: int,
                      ckpt_dir: str, *, max_restarts: int = 10):
    """Drive training to ``total_steps`` across injected failures.

    ``make_trainer()`` -> object with .state, .run(from_step, to_step),
    .restore(step) -> state.  Returns (final_state, n_restarts, history).
    """
    restarts = 0
    history = []
    while True:
        trainer = make_trainer()
        start = latest_step(ckpt_dir)
        if start is not None:
            trainer.state = trainer.restore(start)
            step = start
        else:
            step = 0
        try:
            step, hist = trainer.run(from_step=step, to_step=total_steps)
            history.extend(hist)
            return trainer.state, restarts, history
        except InjectedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            history.append(("restart", step))
