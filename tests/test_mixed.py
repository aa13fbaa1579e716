"""--precision=mixed: int16 fixed-point storage, fp32 math (ops/mixed.py).

The reference has no counterpart (its precision axis is single/double).
Gates: the quantization grid is exact under round-trips, sharded runs
reproduce one device bitwise, chunking does not leak extra rounding, and
transport physics survives 16-bit storage.
"""
import sys

import numpy as np
import pytest

sys.path.insert(0, 'examples')


def test_quant_roundtrip_identity():
    """quantize(dequantize(q)) == q for EVERY int16 code and every
    distribution -- the property that makes chunk boundaries, output
    and checkpoints rounding-free."""
    import jax.numpy as jnp

    from sailfish_tpu import lattice
    from sailfish_tpu.ops.mixed import MixedScales

    for name in ('D2Q9', 'D3Q19'):
        mx = MixedScales(lattice.get_grid(name))
        codes = jnp.arange(-32768, 32768, dtype=jnp.int16)
        for i in range(lattice.get_grid(name).Q):
            back = mx.quant_i(i, mx.dequant_i(i, codes))
            assert np.array_equal(np.asarray(back), np.asarray(codes)), \
                (name, i)


def test_mixed_chunk_independence():
    """12 iterations in one chunk == 3 chunks of 4: chunk boundaries
    round-trip the state through the public fp32 layout and must not add
    rounding."""
    from ldc_3d import LDCSim
    from sailfish_tpu.controller import LBSimulationController

    def run(every):
        ctrl = LBSimulationController(LDCSim, default_config=dict(
            lat_nx=16, lat_ny=16, lat_nz=16, max_iters=12, every=every,
            quiet=True, precision='mixed'))
        ctrl.run(ignore_cmdline=True)
        return np.asarray(ctrl._runner.f)

    assert np.array_equal(run(12), run(4))


def test_mixed_sharded_two_axis_yx():
    """('y','x')-sharded mixed stepping on the GSPMD path reproduces the
    single-device trajectory bitwise: the per-step quantization is
    elementwise, so sharding cannot move a rounding tie."""
    from taylor_green_2d import TaylorGreenSim
    from sailfish_tpu.controller import LBSimulationController

    def run(mesh):
        ctrl = LBSimulationController(TaylorGreenSim, default_config=dict(
            lat_nx=256, lat_ny=128, max_iters=16, every=16, visc=0.01,
            quiet=True, mesh=mesh, precision='mixed'))
        ctrl.run(ignore_cmdline=True)
        r = ctrl._runner
        r._fields_to_host()
        return r.mesh, np.asarray(r.f), np.array(r.sim.vx)

    _, f_ref, vx_ref = run('')
    mesh, f, vx = run('2x2')
    assert mesh.axis_names == ('y', 'x')
    assert np.array_equal(vx, vx_ref)
    assert np.array_equal(f, f_ref)


def test_mixed_viscosity_decay():
    """Shear-wave decay: 16-bit storage keeps measured viscosity within
    1.5% (fp32 gives ~0.1%; bf16 storage would give ~35%)."""
    import jax
    import jax.numpy as jnp

    from sailfish_tpu import equilibrium as eq
    from sailfish_tpu import lattice
    from sailfish_tpu.ops.step import StepBuilder
    from sailfish_tpu.subdomain import NodeMaps

    N, visc, u0, steps = 64, 0.02, 0.01, 400
    grid = lattice.get_grid('D3Q19')
    maps = NodeMaps((8, 8, N), 3)
    b = StepBuilder(grid, maps, visc=visc, storage='int16')
    k = 2 * np.pi / N
    hx = np.arange(N)
    rho = jnp.ones((8, 8, N), jnp.float32)
    uy = jnp.asarray(np.tile(u0 * np.sin(k * hx), (8, 8, 1)),
                     jnp.float32)
    u = jnp.stack([jnp.zeros_like(rho), uy, jnp.zeros_like(rho)])
    f = eq.bgk_equilibrium(grid, rho, u)
    step = b.build()
    run = jax.jit(lambda f, n: jax.lax.fori_loop(
        0, n, lambda i, fc: step(fc, i), f), static_argnums=1)

    def mode_amp(f):
        _, u_out = eq.macroscopic(grid, b.streamed(f))
        return np.abs(np.fft.rfft(np.asarray(u_out[1][4, 4]))[1]) / N

    f = run(f, steps)
    a1 = mode_amp(f)
    f = run(f, steps)
    a2 = mode_amp(f)
    nu = -np.log(a2 / a1) / (k * k * steps)
    assert abs(nu - visc) / visc < 0.015, nu


def test_mixed_rejects_unsupported():
    """Shan-Chen / multiphase scenes must fail loudly, not clip
    silently."""
    import pytest

    from sailfish_tpu import lattice
    from sailfish_tpu.ops.step import StepBuilder
    from sailfish_tpu.subdomain import NodeMaps

    maps = NodeMaps((8, 8, 8), 3)
    with pytest.raises(NotImplementedError):
        StepBuilder(lattice.get_grid('D3Q19'), maps, visc=0.1,
                    sc_coupling=-5.0, storage='int16')


def test_mixed_sharded_matches_single_device():
    """z-sharded stepping under mixed storage reproduces the
    single-device trajectory bitwise."""
    from ldc_3d import LDCSim
    from sailfish_tpu.controller import LBSimulationController

    def run(mesh):
        ctrl = LBSimulationController(LDCSim, default_config=dict(
            lat_nx=16, lat_ny=16, lat_nz=16, max_iters=12, every=12,
            quiet=True, precision='mixed', mesh=mesh))
        ctrl.run(ignore_cmdline=True)
        r = ctrl._runner
        r._fields_to_host()
        return np.asarray(r.f)

    assert np.array_equal(run(''), run('4'))


def test_mixed_2d_sharded_matches_single_device():
    """y-sharded 2D stepping under mixed storage: bitwise vs one
    device."""
    from ldc_2d import LDCSim
    from sailfish_tpu.controller import LBSimulationController

    def run(mesh):
        ctrl = LBSimulationController(LDCSim, default_config=dict(
            lat_nx=64, lat_ny=256, max_iters=12, every=12,
            quiet=True, precision='mixed', mesh=mesh))
        ctrl.run(ignore_cmdline=True)
        r = ctrl._runner
        r._fields_to_host()
        return np.asarray(r.f)

    assert np.array_equal(run(''), run('4'))
