"""Generic on-device data processing: axis reductions, product
statistics, and slice extraction over macroscopic fields.

Counterpart of the reference's
``templates/data_processing.mako`` reduction-kernel generator
(``reduction`` :318, ``stats_global`` :489): where the reference renders
a bespoke CUDA kernel per statistic, here a statistic is a traced JAX
reduction built at runtime and either evaluated on demand or woven into
the jitted main loop as a per-iteration device hook (time series with
no host sync).

A statistic follows the reference's spec format: a list of product
terms ``[(field_index, power), ...]``; e.g. ``[(0, 1)]`` is <f0>,
``[(0, 2)]`` is <f0^2>, ``[(0, 1), (1, 1)]`` is the <f0 f1>
correlation. ``axis`` names the axis NOT reduced over (None = reduce to
a scalar), matching the reference's axis parameter.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from sailfish_tpu.models.base import LBMixIn

#: built-in field getters: fn(rho, u) -> array
FIELD_GETTERS = {
    'rho': lambda rho, u: rho,
    'vx': lambda rho, u: u[0],
    'vy': lambda rho, u: u[1],
    'vz': lambda rho, u: u[2],
    'usq': lambda rho, u: jnp.sum(u * u, axis=0),
}

_OPS = {
    'sum': jnp.sum,
    'mean': jnp.mean,
    'max': jnp.max,
    'min': jnp.min,
}


def _resolve_fields(fields):
    out = []
    for fd in fields:
        if callable(fd):
            out.append(fd)
        else:
            out.append(FIELD_GETTERS[fd])
    return out


def build_reducer(builder, dim, fields, stats=(((0, 1),),), axis=None,
                  op='sum', dtype=jnp.float64):
    """Returns reduce(f) -> (n_stats, ...) jittable reduction over the
    current state. ``axis``: spatial axis kept ('x'/'y'/'z' or None)."""
    getters = _resolve_fields(fields)
    opf = _OPS[op]
    if axis is None:
        reduce_axes = tuple(range(dim))
    else:
        comp = {'x': 0, 'y': 1, 'z': 2}[axis]
        keep = dim - 1 - comp
        reduce_axes = tuple(a for a in range(dim) if a != keep)

    def reduce_fn(f, it=0):
        rho, u = builder.macro_fields(f, it)
        if isinstance(rho, (tuple, list)):   # multi-component models
            rho = rho[0]
        vals = [g(rho, u).astype(dtype) for g in getters]
        outs = []
        for term in stats:
            prod = None
            for fid, power in term:
                v = vals[fid]
                p = v if power == 1 else v ** power
                prod = p if prod is None else prod * p
            outs.append(opf(prod, axis=reduce_axes))
        return jnp.stack(outs)

    return reduce_fn


def build_slicer(builder, dim, axis, position, fields=('rho',)):
    """Returns slice_fn(f) -> (n_fields, *plane) extracting an
    axis-aligned slice of the macroscopic fields (the device half of the
    reference's Vis2DSliceMixIn / ExtractSliceUsq machinery)."""
    getters = _resolve_fields(fields)
    comp = {'x': 0, 'y': 1, 'z': 2}[axis]

    def slice_fn(f, it=0):
        rho, u = builder.macro_fields(f, it)
        if isinstance(rho, (tuple, list)):
            rho = rho[0]
        out = []
        for g in getters:
            v = g(rho, u)
            arr_axis = v.ndim - 1 - comp
            out.append(jax.lax.index_in_dim(v, position, arr_axis,
                                            keepdims=False))
        return jnp.stack(out)

    return slice_fn


class DataProcessingMixIn(LBMixIn):
    """User-facing registration API for reductions/slices.

    On-demand:   v = self.compute_reduction(runner, name)
    Time series: self.add_reduction(runner, name, ..., every=k) inside
    before_main_loop, then self.reduction_series(name) afterwards.
    """

    def _dp_state(self):
        if not hasattr(self, '_dp_reducers'):
            self._dp_reducers = {}
            self._dp_hooks = {}
        return self._dp_reducers, self._dp_hooks

    def add_reduction(self, runner, name, fields, stats=(((0, 1),),),
                      axis=None, op='sum', every=None):
        reducers, hooks = self._dp_state()
        fn = build_reducer(runner.builder, self.dim, fields, stats,
                           axis, op)
        reducers[name] = jax.jit(fn)
        if every is None:
            return
        # samples land at iterations every, 2*every, ... in slots 0, 1,
        # ... (no spurious zero row at the head)
        nslots = max(self.config.max_iters // every, 1)
        shapes = jax.eval_shape(fn, runner.f)
        series0 = jnp.zeros((nslots,) + shapes.shape, shapes.dtype)

        def hook(f, series, it, _fn=fn, _e=every):
            def do(series):
                return series.at[it // _e - 1].set(_fn(f, it))
            return jax.lax.cond(jnp.mod(it, _e) == 0, do,
                                lambda s: s, series)

        hooks[name] = (self.add_device_hook(series0, hook, every=every),
                       runner)

    def add_slice(self, runner, name, axis, position, fields=('rho',)):
        reducers, _ = self._dp_state()
        reducers[name] = jax.jit(build_slicer(
            runner.builder, self.dim, axis, position, fields))

    def compute_reduction(self, runner, name):
        reducers, _ = self._dp_state()
        return np.asarray(reducers[name](runner.f, self.iteration))

    # alias matching the slice terminology
    compute_slice = compute_reduction

    def reduction_series(self, name):
        _, hooks = self._dp_state()
        hook_id, runner = hooks[name]
        return np.asarray(runner.device_hook_state[hook_id])
