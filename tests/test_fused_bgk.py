"""The fused D3Q19 BGK kernel (ops/fused_bgk.py) in the Pallas interpreter
against StepBuilder's XLA step, its scope, and the runner's choice of
step. The kernel itself compiles only for a GPU (Triton)."""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'examples'))

import chip_smoke  # noqa: E402
from sailfish_tpu.controller import LBSimulationController  # noqa: E402
from sailfish_tpu.ops import fused_bgk  # noqa: E402


def _runner(sim_cls, **cfg):
    ctrl = LBSimulationController(sim_cls, default_config=dict(
        max_iters=0, quiet=True, **cfg))
    ctrl.run(ignore_cmdline=True)
    return ctrl._runner


def _box(shape, fraction=0.1):
    nz, ny, nx = shape

    class Box(chip_smoke.SolidBox):
        solid_fraction = fraction

    class BoxSim(chip_smoke.SolidBoxSim):
        subdomain = Box

    return _runner(BoxSim, lat_nx=nx, lat_ny=ny, lat_nz=nz)


@pytest.mark.parametrize('shape,fraction', [
    ((16, 16, 16), 0.1),    # whole blocks
    ((10, 12, 14), 0.2),    # a partial tail block
    ((4, 4, 8), 0.0),       # fluid only, less than one block
])
def test_matches_xla_step(shape, fraction):
    r = _box(shape, fraction)
    assert fused_bgk.unsupported(r.builder) == []
    fused = jax.jit(fused_bgk.fused_step(r.builder, interpret=True))
    xla = jax.jit(r.builder.build())
    a = b = r.f
    for _ in range(6):
        a, b = fused(a), xla(b)
    assert np.isfinite(np.asarray(a)).all()
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize('cfg,reason', [
    (dict(model='mrt'), 'model mrt'),
    (dict(precision='mixed'), 'int16 storage'),
    (dict(grid='D3Q27'), 'grid D3Q27'),
    (dict(subgrid='les-smagorinsky'), 'subgrid model'),
    (dict(incompressible=True), 'incompressible equilibrium'),
])
def test_unsupported_names_reason(cfg, reason):
    r = _runner(chip_smoke.SolidBoxSim, lat_nx=8, lat_ny=8, lat_nz=8, **cfg)
    assert reason in fused_bgk.unsupported(r.builder)
    with pytest.raises(ValueError, match=reason):
        fused_bgk.fused_step(r.builder)


def test_unsupported_past_int32_offsets():
    """A state of 2**31 values or more stays on the XLA step: the kernel
    addresses it with int32 offsets."""
    import copy
    r = _box((8, 8, 8))
    big = copy.copy(r.builder)
    big.maps = copy.copy(r.builder.maps)
    for n, fits in ((483, True), (484, False)):   # 19 * n^3 vs 2**31
        big.maps.type_map = np.broadcast_to(np.int32(0), (n, n, n))
        reasons = fused_bgk.unsupported(big)
        assert (reasons == []) == fits, (n, reasons)


def test_unsupported_other_scenes():
    from ldc_2d import LDCSim as LDC2D
    from ldc_3d import LDCSim
    r = _runner(LDCSim, lat_nx=8, lat_ny=8, lat_nz=8)
    assert any('NTRegularizedVelocity' in why
               for why in fused_bgk.unsupported(r.builder))
    r2 = _runner(LDC2D, lat_nx=8, lat_ny=8)
    assert 'grid D2Q9' in fused_bgk.unsupported(r2.builder)
    assert 'device mesh' in fused_bgk.unsupported(r.builder, mesh=object())


def test_runner_picks_kernel_on_gpu_only(monkeypatch):
    """On a GPU backend the runner steps an eligible scene with the fused
    kernel and every other scene with the XLA step; elsewhere always with
    the XLA step."""
    from ldc_3d import LDCSim
    r_cpu = _box((8, 8, 16))
    assert r_cpu.step_kernel == 'xla'
    monkeypatch.setattr(jax, 'default_backend', lambda: 'gpu')
    for name in ('fused_step', 'fused_loop'):
        monkeypatch.setattr(fused_bgk, name, functools.partial(
            getattr(fused_bgk, name), interpret=True))
    r = _box((8, 8, 16))
    assert r.step_kernel == 'fused_bgk'
    assert _runner(LDCSim, lat_nx=8, lat_ny=8, lat_nz=8).step_kernel == 'xla'
    f0 = jnp.asarray(np.asarray(r.f))
    got = np.asarray(r._run_steps(r.f, 5, 0))
    step = r.builder.build()
    want = np.asarray(jax.lax.fori_loop(0, 5, lambda i, a: step(a, i), f0))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize('n', [0, 1, 2, 7])
def test_loop_matches_steps(n):
    """The ping-pong loop (two steps per iteration, an odd step at the
    end) equals n single steps."""
    r = _box((8, 8, 8))
    run = jax.jit(fused_bgk.fused_loop(r.builder, interpret=True),
                  static_argnums=1)
    step = jax.jit(fused_bgk.fused_step(r.builder, interpret=True))
    want = r.f
    for _ in range(n):
        want = step(want)
    np.testing.assert_array_equal(np.asarray(run(r.f, n)),
                                  np.asarray(want))
