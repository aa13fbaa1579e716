#!/usr/bin/env python
"""One-card MLUPS sweep over domain sizes and lattices.

Counterpart of the reference's benchmark/2d_1block.py + perftest harness
(perftest/tests.py:17-60): runs LDC at a series of domain sizes for D2Q9
and D3Q19 and writes `<out>.dat` rows of  size  mlups, the same figure of
merit as perftest/results/*/blocksize/*. Each measurement is timed on the
host clock around ``jax.block_until_ready``; the card's name and power
limit head the output. Refuses any platform but ``gpu``.
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def run_case(grid, n, iters, warmup):
    import jax

    from sailfish_tpu import geo as geo_mod
    from sailfish_tpu.runner import SubdomainRunner

    if grid == 'D2Q9':
        sys.path.insert(0, os.path.join(REPO, 'examples'))
        from ldc_2d import LDCSim
        dims = {'lat_nx': n, 'lat_ny': n}
        geo_cls = geo_mod.LBGeometry2D
        nodes = n * n
    else:
        sys.path.insert(0, os.path.join(REPO, 'examples'))
        from ldc_3d import LDCSim
        dims = {'lat_nx': n, 'lat_ny': n, 'lat_nz': n, 'grid': grid}
        geo_cls = geo_mod.LBGeometry3D
        nodes = n ** 3

    from sailfish_tpu.controller import LBSimulationController
    ctrl = LBSimulationController(LDCSim, default_config=dict(
        max_iters=0, quiet=True, **dims))
    defaults = {}
    LDCSim.update_defaults(defaults)
    defaults.update(ctrl._default_config)
    config = ctrl.config_parser.parse([], internal_defaults=defaults)
    LDCSim.modify_config(config)
    sim = LDCSim(config)
    runner = SubdomainRunner(sim, geo_cls(config))
    runner._init_geometry()
    runner._init_fields()
    runner._init_state()

    f = runner._run_steps(runner.f, warmup, 0)
    jax.block_until_ready(f)
    t0 = time.perf_counter()
    f = runner._run_steps(f, iters, warmup)
    jax.block_until_ready(f)
    dt = time.perf_counter() - t0
    return nodes * iters / dt / 1e6


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--out', type=str, default='single_chip')
    p.add_argument('--iters', type=int, default=100)
    p.add_argument('--warmup', type=int, default=20)
    p.add_argument('--sizes2d', type=str, default='256,512,1024,2048')
    p.add_argument('--sizes3d', type=str, default='64,128,192,256')
    args = p.parse_args()
    import jax

    from sailfish_tpu import util
    util.enable_compile_cache()
    cards = util.gpu_cards()
    util.require_gpu(jax.devices())
    print(cards[0], jax.devices()[0].device_kind)

    for grid, sizes in (('D2Q9', args.sizes2d), ('D3Q19', args.sizes3d)):
        fname = f'{args.out}_{grid.lower()}.dat'
        with open(fname, 'w') as out:
            for n in (int(s) for s in sizes.split(',') if s):
                mlups = run_case(grid, n, args.iters, args.warmup)
                line = f'{n} {mlups}'
                print(f'{grid} {line}  [{cards[0]}]')
                out.write(line + '\n')
        print('wrote', fname)


if __name__ == '__main__':
    main()
