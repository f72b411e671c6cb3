"""Computing-capacity estimation (paper §III-D, Eqs. 1-3).

C_i = T̃_e^i / Σ_{j=start_i}^{end_i} T_e,j^0  — the ratio of worker i's
measured execution time over its current layer range to the central node's
profiled time for the same range. C_0 = 1.0 by definition.
"""
from __future__ import annotations

import dataclasses
import numpy as np


@dataclasses.dataclass
class CapacityEstimator:
    layer_times0: np.ndarray          # central-node profiled T_e,j^0 [L]
    num_workers: int
    ema: float = 0.0                  # 0 = paper behavior (latest sample wins)

    def __post_init__(self):
        self.layer_times0 = np.asarray(self.layer_times0, float)
        self.capacities = np.ones(self.num_workers, float)
        self._have_sample = np.zeros(self.num_workers, bool)
        self._have_sample[0] = True

    def update(self, worker: int, measured_time: float, start: int, end: int):
        """Record worker's average per-batch execution time over [start, end]."""
        if worker == 0:
            return                    # C_0 := 1.0 (Eq. 1 normalization)
        ref = float(np.sum(self.layer_times0[start:end + 1]))
        if ref <= 0 or measured_time <= 0:
            return
        c = measured_time / ref
        if self.ema > 0 and self._have_sample[worker]:
            c = self.ema * self.capacities[worker] + (1 - self.ema) * c
        self.capacities[worker] = c
        self._have_sample[worker] = True

    def estimated_layer_times(self, worker: int) -> np.ndarray:
        """Eq. 3: T_e,j^i = T_e,j^0 * C_i."""
        return self.layer_times0 * self.capacities[worker]

    def all_reported(self) -> bool:
        return bool(self._have_sample.all())

    def drop_workers(self, failed: list[int]) -> "CapacityEstimator":
        """Capacities for the surviving worker list (fault recovery)."""
        keep = [i for i in range(self.num_workers) if i not in set(failed)]
        est = CapacityEstimator(self.layer_times0, len(keep), self.ema)
        est.capacities = self.capacities[keep].copy()
        est._have_sample = self._have_sample[keep].copy()
        est.capacities[0] = 1.0
        return est

    def add_worker(self, capacity: float = 1.0,
                   have_sample: bool = True) -> "CapacityEstimator":
        """Capacities for a GROWN worker list (elastic admission, appended
        at the end): the joiner enters at ``capacity`` — a probe result, a
        spec'd value, or the paper's homogeneity assumption (1.0, §III-B)
        until its first measured segment refines it."""
        est = CapacityEstimator(self.layer_times0, self.num_workers + 1,
                                self.ema)
        est.capacities = np.append(self.capacities, float(capacity))
        est._have_sample = np.append(self._have_sample, bool(have_sample))
        est.capacities[0] = 1.0
        est._have_sample[0] = True
        return est
