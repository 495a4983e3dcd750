"""Straggler detection: a per-step wall-time EWMA and an outlier threshold.

A step slower than ``threshold`` times the running EWMA is flagged (for a
launcher to drain or replace the host at the next checkpoint boundary).
``clock`` is the time source (``time.monotonic``; a test injects its
own).  On the card a step's time is its host time: the caller ends a step
after the work it waits for (the train step reads its metrics).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 2.0        # step slower than threshold × EWMA flags
    alpha: float = 0.1
    clock: Callable[[], float] = time.monotonic
    _ewma: float | None = None
    flagged_steps: list = dataclasses.field(default_factory=list)
    _t0: float | None = None

    def step_start(self):
        self._t0 = self.clock()

    def step_end(self, step: int) -> bool:
        dt = self.clock() - self._t0
        flagged = False
        if self._ewma is not None and dt > self.threshold * self._ewma:
            self.flagged_steps.append((step, dt, self._ewma))
            flagged = True
        self._ewma = dt if self._ewma is None else (
            self.alpha * dt + (1 - self.alpha) * self._ewma)
        return flagged

    @property
    def mean_step_time(self) -> float | None:
        return self._ewma
