"""Elastic scaling + fault tolerance glue.

Synchronous SPMD posture:
- node failure  -> job restarts from the latest atomic checkpoint;
- resize        -> ``resume_on_mesh`` restores full arrays and keeps
  each rank's shard of every leaf under the *new* mesh's layouts
  (checkpoints are placement-independent by construction);
- stragglers    -> deterministic synchronous steps make stragglers visible
  as step-time outliers; the mitigation at this layer is hot-spare capacity
  plus restart-on-slow (watchdog), both host-side concerns; the step's own
  contribution is staying deterministic (no data-dependent shapes) so any
  replica can replay any step.
"""
from __future__ import annotations

import time
from typing import Any, Callable

from . import checkpoint as ckpt


def resume_on_mesh(ckpt_dir: str, like_state: Any, mesh,
                   sharding_fn: Callable[[Any, Any], Any]):
    """Restore the latest checkpoint onto ``mesh`` (any shape).

    sharding_fn(state_like, mesh) -> a tree shaped as the state of
    ``launch.sharding.Layout``s (each rank keeps its shard of the whole
    leaf, e.g. ``lm_state_shardings``) or of ``torch.device``s (the whole
    leaf moves there).  ``like_state`` has the whole shapes.
    """
    shardings = sharding_fn(like_state, mesh)
    return ckpt.restore(ckpt_dir, like_state, shardings=shardings)


class StepWatchdog:
    """Flags straggler steps: wall-time > factor x trailing median."""

    def __init__(self, factor: float = 3.0, window: int = 32):
        self.factor = factor
        self.times: list[float] = []
        self.window = window
        self.flagged: list[int] = []
        self._t = None

    def start(self):
        self._t = time.perf_counter()

    def stop(self, step: int) -> bool:
        dt = time.perf_counter() - self._t
        self.times.append(dt)
        hist = sorted(self.times[-self.window:])
        med = hist[len(hist) // 2]
        slow = len(self.times) > 4 and dt > self.factor * med
        if slow:
            self.flagged.append(step)
        return slow
