#!/usr/bin/env python
"""Orientation invariance of boundary-condition faces.

The pressure-driven 3D Poiseuille pipe (examples/poiseuille_3d.py,
NTEquilibriumDensity inlet/outlet faces) is run with --flow_direction=x
(faces normal to x) and --flow_direction=z (faces normal to z), both
from the stationary analytic initialization. The deviation from the
analytic profile after N steps is reported for both, and the two
axial-velocity fields are compared after a transpose: the lattice is
cubic-symmetric, so re-orienting a scene changes nothing physical.

Run:  python regtest/orientation_probe.py  [--iters 500]
"""

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def build(direction, n=32):
    sys.path.insert(0, os.path.join(REPO, 'examples'))
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'poiseuille_3d', os.path.join(REPO, 'examples',
                                      'poiseuille_3d.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    from sailfish_tpu import geo as geo_mod
    from sailfish_tpu.controller import LBSimulationController
    from sailfish_tpu.runner import SubdomainRunner

    sim_cls = mod.PoiseuilleSim
    ctrl = LBSimulationController(sim_cls, default_config=dict(
        lat_nx=n, lat_ny=n, lat_nz=n, max_iters=0, quiet=True,
        drive='pressure', stationary=True, flow_direction=direction))
    defaults = {}
    sim_cls.update_defaults(defaults)
    defaults.update(ctrl._default_config)
    config = ctrl.config_parser.parse([], internal_defaults=defaults)
    sim_cls.modify_config(config)
    sim = sim_cls(config)
    runner = SubdomainRunner(sim, geo_mod.LBGeometry3D(config))
    runner._init_geometry()
    runner._init_fields()
    return runner, mod.PoiseuilleSubdomain


def profile_error(direction, iters, n=32):
    """Max deviation of the axial velocity from the analytic profile
    along the centerline cross-section, normalized by max_v."""
    import jax
    runner, sub_cls = build(direction, n)
    runner._init_state()
    f = runner._run_steps(runner.f, iters)
    jax.block_until_ready(f)
    runner.f = f
    runner._fields_to_host()
    sim = runner.sim
    u = {'x': sim.vx, 'y': sim.vy, 'z': sim.vz}[direction]
    # peak axial velocity vs the analytic max_v: the same scalar for
    # every orientation, so the two runs are directly comparable
    max_v = sub_cls.max_v
    umax = float(np.asarray(u).max())
    return abs(umax - max_v) / max_v, np.asarray(u)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--iters', type=int, default=500)
    ap.add_argument('--n', type=int, default=32)
    ap.add_argument('--platform', type=str, default='cpu')
    args = ap.parse_args()
    if args.platform:
        import jax
        jax.config.update('jax_platforms', args.platform)

    fields = {}
    for d in ('x', 'z'):
        err, fields[d] = profile_error(d, args.iters, args.n)
        print(f'flow_direction={d}: peak-velocity error vs analytic '
              f'after {args.iters} steps: {err:.6%}')
    # the whole axial-velocity field is a transpose away: with fields
    # indexed (z, y, x), the z-run's u_z at (k, j, i) is the x-run's
    # u_x at (i, j, k) -- any residual is fp summation-order noise
    d_t = float(np.abs(fields['z']
                       - fields['x'].transpose(2, 1, 0)).max())
    print(f'field-level orientation invariance: max |u_z(z,y,x) - '
          f'u_x(x,y,z)| = {d_t:.3e} (max_v = 0.02)')


if __name__ == '__main__':
    main()
