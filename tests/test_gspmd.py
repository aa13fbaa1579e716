"""Sharded runs on the GSPMD path equal the single-device run.

The domain is one jit-global array sharded over a ``jax.sharding.Mesh``
(``parallel/mesh.py``); XLA's SPMD partitioner turns the streaming shifts
into collective permutes. On the virtual CPU mesh the sharded program
computes exactly what the single-device program computes, so the state
must match bitwise. 2D LDC on y / ('y','x') meshes is covered in
test_physics.test_sharded_equivalence; these cases cover the other model
families and mesh layouts.
"""
import importlib.util
import os

import jax
import numpy as np
import pytest

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'examples')


def _sim_class(relpath, name):
    """A scene class from an example file, imported by path (flat module
    names would collide between examples/ subdirectories)."""
    path = os.path.join(EXAMPLES, relpath)
    spec = importlib.util.spec_from_file_location(
        'gspmd_' + relpath.replace('/', '_')[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, name)


# id: (example file, scene class, config, mesh)
CASES = {
    'ldc3d_z': ('ldc_3d.py', 'LDCSim',
                dict(lat_nx=16, lat_ny=16, lat_nz=16), '4'),
    'ldc3d_zy': ('ldc_3d.py', 'LDCSim',
                 dict(lat_nx=16, lat_ny=16, lat_nz=16), '2x2'),
    'binary_sc3d_z': ('binary_fluid/sc_separation_3d.py', 'SeparationSCSim',
                      dict(lat_nx=16, lat_ny=16, lat_nz=16), '4'),
    'fe_mrt3d_z': ('binary_fluid/fe_viscous_fingering.py', 'FingeringFESim',
                   dict(lat_nx=32, lat_ny=16, lat_nz=16), '4'),
    'tms_channel_z': ('turbulence/channel_flow.py', 'ChannelSim',
                      dict(H=8, Re_tau=60.0, wall='tms', stats_every=5),
                      '4'),
    'binary_sc2d_y': ('binary_fluid/sc_separation_2d.py', 'SeparationSCSim',
                      dict(lat_nx=32, lat_ny=32), '4'),
    'fe2d_yx': ('binary_fluid/fe_separation_2d.py', 'SeparationFESim',
                dict(lat_nx=32, lat_ny=32), '2x2'),
    'mixed16_ldc2d_yx': ('ldc_2d.py', 'LDCSim',
                         dict(lat_nx=32, lat_ny=32, precision='mixed'),
                         '2x2'),
}


def _run(sim_cls, cfg, mesh, steps=12):
    from sailfish_tpu.controller import LBSimulationController
    ctrl = LBSimulationController(sim_cls, default_config=dict(
        cfg, max_iters=steps, every=steps, quiet=True, seed=1234,
        mesh=mesh))
    ctrl.run(ignore_cmdline=True)
    r = ctrl._runner
    return r, [np.asarray(a) for a in jax.tree.leaves(r.f)]


@pytest.mark.parametrize('case', list(CASES))
def test_gspmd_matches_single_device(case):
    relpath, name, cfg, mesh = CASES[case]
    sim_cls = _sim_class(relpath, name)
    _, ref = _run(sim_cls, cfg, '')
    r, got = _run(sim_cls, cfg, mesh)
    n = int(np.prod([int(p) for p in mesh.split('x')]))
    assert r.mesh is not None and r.mesh.devices.size == n
    for leaf in jax.tree.leaves(r.f):
        assert len({s.device for s in leaf.addressable_shards}) == n
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert np.isfinite(a).all()
        assert np.array_equal(a, b), \
            f'{case}: max |diff| {np.abs(a - b).max():.3e}'
