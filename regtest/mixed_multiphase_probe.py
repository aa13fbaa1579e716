#!/usr/bin/env python
"""Does int16 fixed-point storage (--precision=mixed) work for
multiphase scenes?  A committed measurement, not folklore.

``--precision=mixed`` stores each distribution as an int16 code of its
normalized deviation (f/w - 1)/s (ops/mixed.py).  PARITY.md's original
claim was that multiphase deviations "exceed any fixed-point range";
with ``--mixed_range`` that bound is adjustable, so the real question
is PRECISION, not range: a Shan-Chen mixture keeps the minority
component at near-vacuum density (the dissolved phase, rho ~ 1e-4 ..
1e-2), where f/w ~ rho -- the quantization step ws = w *
range/32767 is then comparable to the distribution VALUE itself.
Doubling the range to cover the majority component's |f/w - 1| ~ 1
deviations costs another bit exactly where the minority phase has
none to spare.

This probe runs the stock Laplace-law drop scene
(examples/binary_fluid/sc_laplace_2d.py: R=20 drop, G=3.5, stationary
equilibrium) on the XLA engine with a per-step quantize(dequantize)
wrapper -- the exact storage round-trip the mixed kernels would apply
(the XLA wrapper is the bitwise reference for the single-fluid mixed
kernels, see CLAUDE.md) -- at several ``mixed_range`` values, and
compares against the fp32 run:

  * surface tension: the equilibrium pressure jump dp = sigma/R
  * interface integrity: max |rho - rho_fp32| and total-mass drift

Run:  python regtest/mixed_multiphase_probe.py [--iters 3000]
(CPU is fine; the physics verdict is platform-independent.)
"""

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def build_runner():
    sys.path.insert(0, os.path.join(REPO, 'examples', 'binary_fluid'))
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'sc_laplace_2d',
        os.path.join(REPO, 'examples', 'binary_fluid',
                     'sc_laplace_2d.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    from sailfish_tpu import geo as geo_mod
    from sailfish_tpu.controller import LBSimulationController
    from sailfish_tpu.runner import SubdomainRunner

    sim_cls = mod.LaplaceSim
    ctrl = LBSimulationController(sim_cls, default_config=dict(
        max_iters=0, quiet=True))
    defaults = {}
    sim_cls.update_defaults(defaults)
    defaults.update(ctrl._default_config)
    config = ctrl.config_parser.parse([], internal_defaults=defaults)
    sim_cls.modify_config(config)
    sim = sim_cls(config)
    runner = SubdomainRunner(sim, geo_mod.LBGeometry2D(config))
    runner._init_geometry()
    runner._init_fields()
    runner._init_state()
    return runner, mod.COUPLING


def run(runner, coupling, iters, mixed_range=None):
    """Run the Laplace scene; with ``mixed_range`` set, apply the int16
    storage round-trip to every component after every step."""
    import jax
    import jax.numpy as jnp

    b = runner.builder
    step = b.build()
    g = b.grid
    w = jnp.asarray(np.asarray(g.weights, np.float32))[:, None, None]

    if mixed_range is not None:
        s = np.float32(mixed_range / 32767.0)
        ws = (w * s).astype(jnp.float32)

        def storage(f):
            q = jnp.clip(jnp.round((f - w) / ws), -32768, 32767)
            q = q.astype(jnp.int16)          # the actual storage type
            return w + ws * q.astype(jnp.float32)
    else:
        def storage(f):
            return f

    @jax.jit
    def chunk(state, n):
        def body(i, st):
            return tuple(storage(f) for f in step(st, 0))
        return jax.lax.fori_loop(0, n, body, state)

    state = tuple(storage(f) for f in runner.f)
    state = chunk(state, iters)
    jax.block_until_ready(state)
    rhos, _u = b.macro_fields(state)
    rho = np.asarray(rhos[0])
    phi = np.asarray(rhos[1])
    p = (rho + phi) + coupling * rho * phi
    c = rho.shape[0] // 2, rho.shape[1] // 2
    dp = float(p[c] - p[10, 10])
    return dp, rho, phi


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--iters', type=int, default=3000)
    ap.add_argument('--platform', type=str, default='cpu')
    args = ap.parse_args()
    if args.platform:
        import jax
        jax.config.update('jax_platforms', args.platform)

    runner, G = build_runner()
    dp_ref, rho_ref, phi_ref = run(runner, G, args.iters)
    mass_ref = rho_ref.sum()
    print(f'fp32      : dp = {dp_ref:.6f}')
    print(f'{"range":>9s} : {"dp":>9s}  {"dp err":>8s}  '
          f'{"max|drho|":>9s}  {"mass drift":>10s}  verdict')
    for rng in (0.5, 1.0, 2.0, 4.0, 8.0):
        dp, rho, phi = run(runner, G, args.iters, mixed_range=rng)
        err = abs(dp - dp_ref) / abs(dp_ref)
        drho = np.abs(rho - rho_ref).max()
        mdrift = abs(rho.sum() - mass_ref) / mass_ref
        finite = np.isfinite(rho).all() and np.isfinite(phi).all()
        verdict = ('BLOWN UP' if not finite else
                   'ok' if err < 0.01 and drho < 0.02 else
                   'degraded' if err < 0.10 else 'unusable')
        print(f'{rng:9.1f} : {dp:9.6f}  {err:8.2%}  {drho:9.5f}  '
              f'{mdrift:10.2e}  {verdict}')


if __name__ == '__main__':
    main()
