#!/usr/bin/env python
"""Weak-scaling harness: N devices, domain grown along z with N.

Counterpart of the reference's benchmark/scaling/weak_single_3d.py:12-28
(254x192x300*N lattice, N subdomains on the Z axis). Here the subdomain
count is the size of a z-mesh over the cards of one host; each
measurement is timed on the host clock around ``jax.block_until_ready``.
Refuses any platform but ``gpu``:
  python benchmark/scaling/weak_3d.py --devices 1,2,4
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def run_case(n_devices, base, iters, warmup):
    import jax
    sys.path.insert(0, os.path.join(REPO, 'examples'))
    from ldc_3d import LDCSim

    from sailfish_tpu import geo as geo_mod
    from sailfish_tpu.controller import LBSimulationController
    from sailfish_tpu.runner import SubdomainRunner

    nx, ny, bz = base
    dims = dict(lat_nx=nx, lat_ny=ny, lat_nz=bz * n_devices, grid='D3Q19',
                mesh=str(n_devices) if n_devices > 1 else '')
    ctrl = LBSimulationController(LDCSim, default_config=dict(
        max_iters=0, quiet=True, **dims))
    defaults = {}
    LDCSim.update_defaults(defaults)
    defaults.update(ctrl._default_config)
    config = ctrl.config_parser.parse([], internal_defaults=defaults)
    LDCSim.modify_config(config)
    sim = LDCSim(config)
    runner = SubdomainRunner(sim, geo_mod.LBGeometry3D(config))
    runner._init_geometry()
    runner._init_fields()
    runner._init_state()

    nodes = nx * ny * bz * n_devices
    f = runner._run_steps(runner.f, warmup, 0)
    jax.block_until_ready(f)
    t0 = time.perf_counter()
    f = runner._run_steps(f, iters, warmup)
    jax.block_until_ready(f)
    dt = time.perf_counter() - t0
    return nodes * iters / dt / 1e6


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--devices', type=str, default='1,2,4')
    p.add_argument('--base', type=str, default='128,128,32',
                   help='nx,ny,z-per-device')
    p.add_argument('--iters', type=int, default=50)
    p.add_argument('--warmup', type=int, default=10)
    p.add_argument('--out', type=str, default='weak_3d.dat')
    args = p.parse_args()
    base = tuple(int(x) for x in args.base.split(','))
    import jax

    from sailfish_tpu import util
    util.enable_compile_cache()
    cards = util.gpu_cards()
    util.require_gpu(jax.devices())
    print(cards[0], jax.devices()[0].device_kind)

    results = []
    for n in (int(d) for d in args.devices.split(',') if d):
        mlups = run_case(n, base, args.iters, args.warmup)
        results.append((n, mlups))
        eff = mlups / (results[0][1] * n) * 100.0
        print(f'devices={n}: {mlups} MLUPS total, '
              f'weak-scaling efficiency {eff:.1f}% [{cards[0]}]')
    with open(args.out, 'w') as out:
        for n, mlups in results:
            out.write(f'{n} {mlups:.1f}\n')
    print('wrote', args.out)


if __name__ == '__main__':
    main()
