#!/usr/bin/env python
"""MLUPS across the model zoo: one row per (model family, config).

Counterpart of the reference's perftest matrix (perftest/results/*/
blocksize/{d2q9_bgk, d3q19_bgk, bin_d2q9_fe_bgk, ...}) so every model
family has a measured figure, not just the BGK headline. Writes
`<out>.dat` rows:  name  nodes  mlups, under a header line naming the
card and its power limit. Each measurement is timed on the host clock
around ``jax.block_until_ready``. Refuses any platform but ``gpu``.

    python benchmark/model_zoo.py [--only NAME]
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


CASES = {
    # name: (example module, geo dim, config overrides)
    'd2q9_bgk_ldc_2048': ('ldc_2d', 2,
                          dict(lat_nx=2048, lat_ny=2048)),
    'd3q19_bgk_ldc_256': ('ldc_3d', 3,
                          dict(lat_nx=256, lat_ny=256, lat_nz=256)),
    'd3q19_mrt_ldc_128': ('ldc_3d', 3,
                          dict(lat_nx=128, lat_ny=128, lat_nz=128,
                               model='mrt')),
    'd3q19_trt_ldc_128': ('ldc_3d', 3,
                          dict(lat_nx=128, lat_ny=128, lat_nz=128,
                               model='trt')),
    'd2q9_elbm_ldc_1024': ('ldc_2d', 2,
                           dict(lat_nx=1024, lat_ny=1024,
                                model='elbm')),
    'd3q15_bgk_kida_128': ('turbulence.kida_vortex', 3,
                           dict(lat_nx=128, lat_ny=128, lat_nz=128,
                                visc=0.002)),
    'd3q19_les_sphere_128': ('sphere_3d', 3,
                             dict(lat_nx=128, lat_ny=128, lat_nz=128,
                                  subgrid='les-smagorinsky',
                                  visc=0.005)),
    'd2q9_sc_single_1024': ('sc_phase_separation', 2,
                            dict(lat_nx=1024, lat_ny=1024)),
    'd3q19_sc_single_256': ('sc_phase_separation_3d', 3,
                            dict(lat_nx=256, lat_ny=256, lat_nz=256)),
    'bin_d2q9_fe_512': ('binary_fluid.fe_separation_2d', 2,
                        dict(lat_nx=512, lat_ny=512)),
    'bin_d2q9_fe_1024': ('binary_fluid.fe_separation_2d', 2,
                         dict(lat_nx=1024, lat_ny=1024)),
    'bin_d2q9_sc_512': ('binary_fluid.sc_separation_2d', 2,
                        dict(lat_nx=512, lat_ny=512)),
    'bin_d2q9_sc_1024': ('binary_fluid.sc_separation_2d', 2,
                         dict(lat_nx=1024, lat_ny=1024)),
    'tern_d2q9_sc_512': ('ternary_fluid.sc_drop_2d', 2,
                         dict(lat_nx=512, lat_ny=512)),
    'tern_d2q9_sc_1024': ('ternary_fluid.sc_drop_2d', 2,
                          dict(lat_nx=1024, lat_ny=1024)),
    'bin_d3q19_fe_128': ('binary_fluid.fe_separation_3d', 3,
                         dict(lat_nx=128, lat_ny=128, lat_nz=128)),
    'bin_d3q19_sc_128': ('binary_fluid.sc_separation_3d', 3,
                         dict(lat_nx=128, lat_ny=128, lat_nz=128)),
    'd2q9_bgk_tg_2048': ('taylor_green_2d', 2,
                         dict(lat_nx=2048, lat_ny=2048, visc=0.01)),
    # TMS-wall turbulent channel (complex-BC wall rows normal to y)
    'd3q19_tms_channel_h63': ('turbulence.channel_flow', 3,
                              dict(H=63, wall='tms',
                                   streamwise=384)),
    'd3q19_tms_channel_h63_mixed16': ('turbulence.channel_flow', 3,
                                      dict(H=63, wall='tms',
                                           streamwise=384,
                                           precision='mixed')),
    # FE-MRT collision (the reference's recommended binary model,
    # lb_binary.py:175) vs its BGK sibling
    'bin_d2q9_fe_mrt_1024': ('binary_fluid.fe_separation_2d', 2,
                             dict(lat_nx=1024, lat_ny=1024,
                                  model='mrt')),
    'bin_d3q19_fe_mrt_128': ('binary_fluid.fe_separation_3d', 3,
                             dict(lat_nx=128, lat_ny=128, lat_nz=128,
                                  model='mrt')),
    # --precision=mixed: int16 fixed-point rounding, fp32 math and carry
    # (ops/mixed.py)
    'd3q19_bgk_ldc_256_mixed16': ('ldc_3d', 3,
                                  dict(lat_nx=256, lat_ny=256,
                                       lat_nz=256, precision='mixed')),
    'd2q9_bgk_ldc_2048_mixed16': ('ldc_2d', 2,
                                  dict(lat_nx=2048, lat_ny=2048,
                                       precision='mixed')),
    'd3q19_mrt_ldc_128_mixed16': ('ldc_3d', 3,
                                  dict(lat_nx=128, lat_ny=128,
                                       lat_nz=128, model='mrt',
                                       precision='mixed')),
    'd3q15_bgk_kida_128_mixed16': ('turbulence.kida_vortex', 3,
                                   dict(lat_nx=128, lat_ny=128,
                                        lat_nz=128, visc=0.002,
                                        precision='mixed')),
    'd2q9_elbm_ldc_1024_mixed16': ('ldc_2d', 2,
                                   dict(lat_nx=1024, lat_ny=1024,
                                        model='elbm',
                                        precision='mixed')),
    'd2q9_bgk_tg_4096': ('taylor_green_2d', 2,
                         dict(lat_nx=4096, lat_ny=4096, visc=0.01)),
    # shallow-water equilibrium (LBFreeSurface) and a time-dependent
    # uniform DynamicValue force (poiseuille_pulsatile --drive=force)
    'd2q9_sw_fs_2048': ('fs_gaussian', 2,
                        dict(lat_nx=2048, lat_ny=2048)),
    'd2q9_bgk_pulsatile_2048': ('poiseuille_pulsatile', 2,
                                dict(lat_nx=2048, lat_ny=2048,
                                     drive='force')),
}

SIM_CLASSES = {
    'fs_gaussian': 'FSSim',
    'poiseuille_pulsatile': 'PulsatileSim',
    'ldc_2d': 'LDCSim',
    'ldc_3d': 'LDCSim',
    'turbulence.kida_vortex': 'KidaSim',
    'sphere_3d': 'SphereSimulation',
    'sc_phase_separation': 'SCSim',
    'sc_phase_separation_3d': 'SCSim3D',
    'binary_fluid.fe_separation_2d': 'SeparationFESim',
    'binary_fluid.sc_separation_2d': 'SeparationSCSim',
    'ternary_fluid.sc_drop_2d': 'TernaryDropSim',
    'binary_fluid.fe_separation_3d': 'SeparationFESim3D',
    'binary_fluid.sc_separation_3d': 'SeparationSCSim',
    'taylor_green_2d': 'TaylorGreenSim',
    'turbulence.channel_flow': 'ChannelSim',
}


def run_case(name, iters, warmup):
    import importlib

    import jax
    import numpy as np

    from sailfish_tpu import geo as geo_mod
    from sailfish_tpu.controller import LBSimulationController
    from sailfish_tpu.runner import SubdomainRunner

    module, dim, overrides = CASES[name]
    for sub in ('examples', 'examples/turbulence',
                'examples/binary_fluid', 'examples/ternary_fluid'):
        p = os.path.join(REPO, sub)
        if p not in sys.path:
            sys.path.append(p)  # for intra-example imports only
    # import by file path: flat-name imports would collide on duplicate
    # example filenames (sc_drop_2d.py exists in binary_fluid/ AND
    # ternary_fluid/)
    rel = module.replace('.', '/') + '.py'
    spec = importlib.util.spec_from_file_location(
        'zoo_' + module.replace('.', '_'),
        os.path.join(REPO, 'examples', rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sim_cls = getattr(mod, SIM_CLASSES[module])

    ctrl = LBSimulationController(sim_cls, default_config=dict(
        max_iters=0, quiet=True, **overrides))
    defaults = {}
    sim_cls.update_defaults(defaults)
    defaults.update(ctrl._default_config)
    config = ctrl.config_parser.parse([], internal_defaults=defaults)
    sim_cls.modify_config(config)
    sim = sim_cls(config)
    geo_cls = geo_mod.LBGeometry2D if dim == 2 else geo_mod.LBGeometry3D
    runner = SubdomainRunner(sim, geo_cls(config))
    runner._init_geometry()
    runner._init_fields()
    runner._init_state()

    nodes = int(np.prod(runner._domain_shape()))
    f = runner._run_steps(runner.f, warmup, 0)
    jax.block_until_ready(f)
    t0 = time.perf_counter()
    f = runner._run_steps(f, iters, warmup)
    jax.block_until_ready(f)
    dt = time.perf_counter() - t0
    leaves = jax.tree.leaves(f)
    assert all(bool(jax.numpy.isfinite(l).all()) for l in leaves), name
    return nodes * iters / dt / 1e6, nodes


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--out', type=str, default='model_zoo')
    p.add_argument('--iters', type=int, default=200)
    p.add_argument('--warmup', type=int, default=10)
    p.add_argument('--only', type=str, default='')
    args = p.parse_args()
    import jax

    from sailfish_tpu import util
    util.enable_compile_cache()
    cards = util.gpu_cards()
    util.require_gpu(jax.devices())
    header = f'# {cards[0]}, {jax.devices()[0].device_kind}'
    print(header)

    fname = f'{args.out}.dat'
    with open(fname, 'w') as out:
        out.write(header + '\n')
        for name in CASES:
            if args.only and args.only not in name:
                continue
            try:
                mlups, nodes = run_case(name, args.iters, args.warmup)
            except Exception as e:
                print(f'{name:<24s} FAILED: {e}')
                continue
            line = f'{name} {nodes} {mlups}'
            print(line)
            out.write(line + '\n')
    print('wrote', fname)


if __name__ == '__main__':
    main()
