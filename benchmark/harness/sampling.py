"""Which steps (or chunks) of a window the check compares.

The first is always kept: it starts from the benchmark's own inputs. Of the
rest, `k` are kept by reservoir sampling as the window runs, so that
without knowing beforehand how many the window completes, each has the same
chance to be kept. The draws come from the run's seed, one per step in a
fixed order.
"""

from __future__ import annotations

import numpy as np


class Sampler:
    def __init__(self, seed: int, k: int):
        self.rng = np.random.default_rng([int(seed) & ((1 << 63) - 1), 17])
        self.k = k
        self.kept = {}            # slot -> sample; slot -1 is the first

    def slot(self, i: int):
        """The slot that step i goes to, or None when it is not kept."""
        if i == 0:
            return -1
        j = i - 1
        if j < self.k:
            return j
        r = int(self.rng.integers(0, j + 1))
        return r if r < self.k else None

    def stop(self):
        """Keep no later step (the traced slice after the window)."""
        self.k = -1

    def draw(self, lo: int, hi: int) -> int:
        return int(self.rng.integers(lo, hi))

    def samples(self):
        return [self.kept[s] for s in sorted(self.kept)]
