"""Mixed-precision storage: int16 fixed-point distributions, fp32 math.

``--precision=mixed`` rounds each distribution, every step, to a 16-bit
fixed-point code of its normalized deviation from rest,

    q_i = round((f_i / w_i - 1) / s),   s = mixed_range / 32767,

while every arithmetic operation -- moments, equilibrium, collision,
boundary conditions -- runs in fp32 on dequantized values. This is the
counterpart of the FP16S compressed-storage technique of Lehmann et
al., "Accuracy and performance of the lattice Boltzmann method with
64-bit, 32-bit and customized 16-bit floating point precision", Phys.
Rev. E 106 (2022): like their equilibrium-shifted fp16, precision is
spent on the hydrodynamically active deviation instead of the constant
rest weight. Fixed point beats 16-bit floats here (bf16's 8 mantissa
bits measurably corrupt transport -- a shear-decay viscosity test misses
by ~35%): for a
deviation bounded by ``mixed_range`` the int16 grid gives a UNIFORM
absolute error of s/2 ~ 7.6e-6, i.e. ~15 significant bits at full
amplitude (measured shear-decay viscosity error: 0.5% at u=0.01 where
fp32 gives 0.09%).

Exactness contract (what makes the mode testable and chunk-safe):
  * ``quantize`` after ``dequantize`` is the identity for every int16
    code: |fl(w + ws*q) - w - ws*q| <= ulp(w)/2 = w*2^-24, which is
    under 1e-3 of one quantization step for every lattice weight, so
    the re-rounded code is unchanged. State can round-trip through the
    public fp32 layout (chunk boundaries, checkpoints, output) with no
    drift: the per-step quantization wrapper (StepBuilder.build with
    storage='int16') is bit-identical to an int16 carry.
  * Saturation: deviations beyond ``mixed_range`` clip. The default
    range 0.5 covers |f/w - 1| up to 0.5 -- ample for lattice Mach
    numbers through ~0.1 with O(5%) density variation; raise
    ``--mixed_range`` for stronger forcing (each doubling costs one
    bit of precision).

The reference has no counterpart (its precision axis is
single/double, codegen.py:19-29). The step is bound by memory bandwidth,
so an int16 carry would halve its bytes; but the step as built here
keeps the carry in fp32 (StepBuilder.build quantizes and dequantizes in
the same step), so today the mode changes the numerics and not the
bytes moved.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

#: int16 code range; +-32767 (the -32768 code is produced only by
#: clipping, keeping the grid symmetric).
QMAX = 32767.0

#: default normalized-deviation range (see module docstring)
DEFAULT_RANGE = 0.5


class MixedScales:
    """Per-distribution quantization constants, all baked to fp32.

    ``w``: lattice weights; ``ws`` = w * s (one code step in f units);
    ``inv_ws`` = 1 / ws. Scalar python floats per distribution so both
    the Pallas kernels and the XLA wrapper fold them as immediates."""

    def __init__(self, grid, range_=DEFAULT_RANGE):
        self.range = float(range_)
        s = np.float32(self.range / QMAX)
        w = np.asarray(grid.weights, np.float32)
        self.w = [float(v) for v in w]
        self.ws = [float(np.float32(v * s)) for v in w]
        self.inv_ws = [float(np.float32(1.0) / np.float32(v * s))
                       for v in w]
        # (Q, 1, ..) broadcastable device constants for full-state ops
        self._w_col = None
        self._ws_col = None
        self._inv_col = None

    def _cols(self, ndim):
        shape = (-1,) + (1,) * (ndim - 1)
        w = jnp.asarray(np.asarray(self.w, np.float32)).reshape(shape)
        ws = jnp.asarray(np.asarray(self.ws, np.float32)).reshape(shape)
        inv = jnp.asarray(np.asarray(self.inv_ws,
                                     np.float32)).reshape(shape)
        return w, ws, inv

    # -- per-distribution (kernel-side) ---------------------------------

    def dequant_i(self, i, q):
        """int16 code plane of distribution ``i`` -> fp32 values."""
        return np.float32(self.w[i]) + (
            np.float32(self.ws[i]) * q.astype(jnp.float32))

    def quant_i(self, i, f):
        """fp32 plane of distribution ``i`` -> int16 codes."""
        d = (f - np.float32(self.w[i])) * np.float32(self.inv_ws[i])
        return jnp.clip(jnp.round(d), -32768.0, QMAX).astype(jnp.int16)

    # -- whole-state (XLA-side); axis 0 must be the Q axis ---------------

    def dequant(self, q, qorder=None):
        """(Q, ...) int16 -> fp32. ``qorder``: permutation giving the
        standard index of each array channel (kernel layouts)."""
        w, ws, _ = self._cols(q.ndim)
        if qorder is not None:
            w = w[jnp.asarray(qorder)]
            ws = ws[jnp.asarray(qorder)]
        return w + ws * q.astype(jnp.float32)

    def quant(self, f, qorder=None):
        """(Q, ...) fp32 -> int16 codes."""
        w, _, inv = self._cols(f.ndim)
        if qorder is not None:
            w = w[jnp.asarray(qorder)]
            inv = inv[jnp.asarray(qorder)]
        d = (f - w) * inv
        return jnp.clip(jnp.round(d), -32768.0, QMAX).astype(jnp.int16)
