"""Flow-statistics mixins: kinetic energy / enstrophy, Reynolds moments.

Counterpart of the reference's ``sailfish/stats.py`` (KineticEnergyEnstrophy
MixIn :16, ReynoldsStatsMixIn :56) and its generated reduction kernels
(templates/data_processing.mako). Here the reductions are jitted jnp
expressions over the device-resident state -- no custom kernel plumbing.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from sailfish_tpu.models.base import LBMixIn, ScalarField


class FlowStatsMixIn(LBMixIn):
    """Easy access to flow statistics for LBFluidSim-descendant classes."""


def _velocity_device(runner):
    """Device (dim, *S) velocity from the current state."""
    _, u = runner._macro(runner.f)
    return u


class KineticEnergyEnstrophyMixIn(FlowStatsMixIn):
    """Global kinetic energy and enstrophy densities
    (reference stats.py:16-54)."""

    @classmethod
    def fields(cls):
        return [ScalarField('v_sq', init=0.0), ScalarField('vort_sq',
                                                           init=0.0)]

    def before_main_loop(self, runner):
        dim = self.dim

        @jax.jit
        def ke_ens(f):
            _, u = runner.builder.macro_fields(f)
            vsq = jnp.sum(u * u, axis=0)
            # vorticity via central differences (periodic roll), matching
            # the reference's finite-difference vorticity kernel
            # (data_processing.mako).
            def d(field, axis_comp):
                ax = field.ndim - 1 - axis_comp
                return (jnp.roll(field, -1, axis=ax)
                        - jnp.roll(field, 1, axis=ax)) * 0.5
            if dim == 2:
                w = d(u[1], 0) - d(u[0], 1)
                vort_sq = w * w
            else:
                wx = d(u[2], 1) - d(u[1], 2)
                wy = d(u[0], 2) - d(u[2], 0)
                wz = d(u[1], 0) - d(u[0], 1)
                vort_sq = wx * wx + wy * wy + wz * wz
            n = vsq.size
            ke = jnp.sum(vsq, dtype=jnp.float64) / (2.0 * n)
            ens = jnp.sum(vort_sq, dtype=jnp.float64) / (2.0 * n)
            return ke, ens

        self._ke_ens_fn = ke_ens

    def compute_ke_enstrophy(self, runner):
        """Kinetic energy and enstrophy densities (per node), summed in
        double precision like the reference (stats.py:44-52)."""
        ke, ens = self._ke_ens_fn(runner.f)
        return float(ke), float(ens)

    # API-compat alias (reference method name has a typo kept for parity)
    compute_ke_enstropy = compute_ke_enstrophy


class ReynoldsStatsMixIn(FlowStatsMixIn):
    """First four moments of flow quantities and pair correlations,
    averaged over the homogeneous axes (reference stats.py:56-200,
    reynolds_statistics.mako).

    Two accumulation modes:
      * DEVICE (default when ``every`` is given): a per-iteration device
        hook accumulates inside the jitted main loop, so sampling cadence
        is independent of the host chunk size (cfg.every) -- the
        equivalent of the reference's on-GPU ring buffer.
      * host: call ``collect_reynolds_stats(runner)`` from after_step
        (the reference's explicit API), accumulating on the host.
    ``reynolds_stats()`` returns whichever accumulator has samples.
    """

    stat_axis = 'y'

    def prepare_reynolds_stats(self, runner, axis=None, every=None,
                               from_iter=0):
        dim = self.dim
        axis = axis or self.stat_axis
        # profile along `axis`: average over the other spatial axes
        comp = {'x': 0, 'y': 1, 'z': 2}[axis]
        keep_ax = (dim - 1) - comp  # array axis kept

        def stats(f):
            rho, u = runner.builder.macro_fields(f)
            reduce_axes = tuple(a for a in range(dim) if a != keep_ax)
            out = {}
            fields = {'rho': rho}
            for a in range(dim):
                out_name = 'uvw'[a] if dim == 3 else 'uv'[a]
                fields[out_name] = u[a]
            for name, fld in fields.items():
                prof = []
                for p in range(1, 5):
                    prof.append(jnp.mean(fld.astype(jnp.float64) ** p,
                                         axis=reduce_axes))
                out[name] = jnp.stack(prof)
            # cross correlations between velocity components
            names = list(fields)
            for i, a in enumerate(names):
                for b in names[i + 1:]:
                    out[a + b] = jnp.mean(
                        fields[a].astype(jnp.float64)
                        * fields[b].astype(jnp.float64),
                        axis=reduce_axes)[None]
            return out

        self._reynolds_fn = jax.jit(stats)
        if not getattr(self, '_reynolds_restored', False):
            self._reynolds_acc = None
            self._reynolds_samples = 0
        self._reynolds_runner = runner
        self._reynolds_hook_id = None
        if every is not None:
            shapes = jax.eval_shape(stats, runner.f)
            acc0 = jax.tree.map(
                lambda s: jnp.zeros(s.shape, s.dtype), shapes)
            init = (jnp.zeros((), jnp.int32), acc0)

            def hook(f, state, it):
                pred = (it >= from_iter) & (jnp.mod(it, every) == 0)

                def do(st):
                    cnt, acc = st
                    s = stats(f)
                    return (cnt + 1,
                            jax.tree.map(lambda a, b: a + b, acc, s))

                return jax.lax.cond(pred, do, lambda st: st, state)

            self._reynolds_hook_id = self.add_device_hook(
                init, hook, every=every, from_iter=from_iter)

    def checkpoint_state(self):
        return {'acc': getattr(self, '_reynolds_acc', None),
                'samples': getattr(self, '_reynolds_samples', 0)}

    def restore_checkpoint_state(self, state):
        self._reynolds_acc = state['acc']
        self._reynolds_samples = state['samples']
        self._reynolds_restored = True

    def collect_reynolds_stats(self, runner):
        sample = jax.tree.map(np.asarray, self._reynolds_fn(runner.f))
        if self._reynolds_acc is None:
            self._reynolds_acc = sample
        else:
            self._reynolds_acc = {k: self._reynolds_acc[k] + v
                                  for k, v in sample.items()}
        self._reynolds_samples += 1
        return sample

    def reynolds_stats(self):
        """Accumulated mean profiles (host samples if any, else the
        device accumulator)."""
        if self._reynolds_samples:
            return {k: v / self._reynolds_samples
                    for k, v in self._reynolds_acc.items()}
        if self._reynolds_hook_id is not None:
            cnt, acc = self._reynolds_runner.device_hook_state[
                self._reynolds_hook_id]
            cnt = int(cnt)
            if cnt == 0:
                return None
            return {k: np.asarray(v) / cnt for k, v in acc.items()}
        return None
