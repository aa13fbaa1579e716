"""Per-phase timing (counterpart of sailfish/profile.py TimeProfile :11).

The reference brackets 8 GPU phases with CUDA events and 5 CPU phases
with decorators (profile.py:122-168). Here the hot loop is a single
jitted device program, so the phase set collapses to: device compute (per
chunk), host sync (device->host field transfer), output writing and
checkpointing; boundary-condition work is folded into compute. MLUPS_total vs
MLUPS_comp (controller.py:740-765) maps to including vs excluding the
host-side phases.
"""

from __future__ import annotations

import time
from collections import namedtuple
from contextlib import contextmanager

import numpy as np

TimingInfo = namedtuple('TimingInfo', ('comp', 'total', 'subdomain_id'))


class TimeProfile:
    # phase ids (reference profile.py:13-36)
    COMP = 'comp'          # device collide+stream
    SYNC = 'host_sync'     # device -> host field transfer
    OUTPUT = 'output'      # file writing
    CHECKPOINT = 'checkpoint'

    def __init__(self, runner=None):
        self._runner = runner
        self._timings = {}
        self._start = time.time()

    @contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._timings.setdefault(name, []).append(
                time.perf_counter() - t0)

    def record(self, name, dt):
        self._timings.setdefault(name, []).append(dt)

    def seconds(self, name):
        return float(np.sum(self._timings.get(name, [0.0])))

    def stats(self):
        """name -> (mean, min, max, std) in seconds
        (reference profile.py:54-103)."""
        return {k: (float(np.mean(v)), float(np.min(v)), float(np.max(v)),
                    float(np.std(v)))
                for k, v in self._timings.items()}

    def summary(self, total_nodes, iters, logger=None):
        """Prints the per-phase report and MLUPS split
        (reference controller.py:740-765)."""
        elapsed = time.time() - self._start
        comp = self.seconds(self.COMP)
        lines = []
        mlups_comp = total_nodes * iters / comp / 1e6 if comp else 0.0
        mlups_total = total_nodes * iters / elapsed / 1e6 if elapsed else 0.0
        lines.append(f'MLUPS_comp: {mlups_comp:.2f}   '
                     f'MLUPS_total: {mlups_total:.2f}')
        for name, (mean, mn, mx, std) in sorted(self.stats().items()):
            lines.append(f'  {name:<12s} mean={mean * 1e3:8.2f} ms  '
                         f'min={mn * 1e3:8.2f}  max={mx * 1e3:8.2f}  '
                         f'std={std * 1e3:8.2f}')
        text = '\n'.join(lines)
        if logger is not None:
            for ln in lines:
                logger.info(ln)
        return text
