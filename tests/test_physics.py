"""Fast physics regression tests (counterparts of regtest/poiseuille.py and
regtest/subdomains equivalence; full-resolution versions in regtest/)."""
import sys

import numpy as np
import pytest

sys.path.insert(0, 'examples')


def _run_controller(sim_cls, geo_cls=None, **cfg):
    from sailfish_tpu.controller import LBSimulationController
    ctrl = LBSimulationController(sim_cls, geo_cls, default_config=cfg)
    ctrl.run(ignore_cmdline=True)
    r = ctrl._runner
    r._fields_to_host()
    return ctrl


@pytest.mark.parametrize('wall', ['fullbb', 'halfbb'])
def test_poiseuille_force_driven(wall):
    from poiseuille import PoiseuilleSim, PoiseuilleSubdomain
    from sailfish_tpu.geo import LBGeometry2D
    N = 32
    ctrl = _run_controller(
        PoiseuilleSim, LBGeometry2D,
        lat_nx=N, lat_ny=N, visc=0.1, max_iters=3000, every=3000,
        quiet=True, wall=wall, stationary=True)
    sim = ctrl._runner.sim
    ref = PoiseuilleSubdomain.velocity_profile(ctrl.config, np.arange(N))
    prof = sim.vy[N // 2, :]
    m = ref > 0
    err = np.max(np.abs(prof[m] - ref[m])) / ref.max()
    assert err < 2e-3, err


def test_ldc_smoke_and_mass_conservation():
    from ldc_2d import LDCSim
    ctrl = _run_controller(LDCSim, lat_nx=48, lat_ny=48,
                           max_iters=500, every=500, quiet=True)
    sim = ctrl._runner.sim
    assert np.all(np.isfinite(sim.rho))
    assert np.all(np.isfinite(sim.vx))
    # lid velocity visible in the flow
    assert sim.vx[-2, 24] > 0.01


@pytest.mark.parametrize('mesh', ['2', '4', '2x2'])
def test_sharded_equivalence(mesh):
    """N-device run must equal the 1-device run bitwise (fp32): the
    analog of the reference's multi-subdomain regtests
    (regtest/subdomains/2d_propagation.py)."""
    from ldc_2d import LDCSim

    def run(m):
        ctrl = _run_controller(LDCSim, lat_nx=32, lat_ny=32,
                               max_iters=120, every=120, quiet=True, mesh=m)
        sim = ctrl._runner.sim
        return np.array(sim.rho), np.array(sim.vx), np.array(sim.vy)

    base = run('')
    test = run(mesh)
    for a, b, name in zip(base, test, ['rho', 'vx', 'vy']):
        assert np.array_equal(a, b), f'{name} differs for mesh {mesh}'


@pytest.mark.slow
def test_sharded_equivalence_3d():
    """2- and 3-axis GSPMD meshes match one device bitwise."""
    from ldc_3d import LDCSim

    def run(m):
        ctrl = _run_controller(LDCSim, lat_nx=16, lat_ny=16, lat_nz=16,
                               max_iters=60, every=60, quiet=True, mesh=m)
        sim = ctrl._runner.sim
        return np.array(sim.rho), np.array(sim.vx), np.array(sim.vz)

    base = run('')
    for mesh in ('2x2', '2x2x2'):
        test = run(mesh)
        for a, b in zip(base, test):
            assert np.array_equal(a, b), mesh


def test_checkpoint_roundtrip(tmp_path):
    """Analog of tests/gpu/checkpoint.sh: run N+M with a restore in the
    middle == straight N+M."""
    from ldc_2d import LDCSim
    cp = str(tmp_path / 'cp')

    ctrl = _run_controller(LDCSim, lat_nx=24, lat_ny=24, max_iters=60,
                           every=60, quiet=True)
    straight = np.array(ctrl._runner.sim.vx)

    _run_controller(LDCSim, lat_nx=24, lat_ny=24, max_iters=40,
                    checkpoint_file=cp, checkpoint_every=40, quiet=True)
    ctrl3 = _run_controller(LDCSim, lat_nx=24, lat_ny=24, max_iters=60,
                            every=60, quiet=True,
                            restore_from=cp + '.last')
    assert np.array_equal(straight, np.array(ctrl3._runner.sim.vx))


def test_norestore_time(tmp_path):
    """--norestore_time: the state restores, the clock restarts at 0
    (reference controller.py:418-422, subdomain_runner.py:1438-1440)."""
    from ldc_2d import LDCSim
    cp = str(tmp_path / 'cp')

    ctrl = _run_controller(LDCSim, lat_nx=24, lat_ny=24, max_iters=60,
                           every=60, quiet=True)
    straight = np.array(ctrl._runner.sim.vx)

    _run_controller(LDCSim, lat_nx=24, lat_ny=24, max_iters=40,
                    checkpoint_file=cp, checkpoint_every=40, quiet=True)
    ctrl3 = _run_controller(LDCSim, lat_nx=24, lat_ny=24, max_iters=20,
                            every=20, quiet=True,
                            restore_from=cp + '.last',
                            restore_time=False)
    # 40 checkpointed + 20 re-clocked steps == straight 60 (the LDC lid
    # is time-independent), and the clock ends at 20, not 60
    assert np.array_equal(straight, np.array(ctrl3._runner.sim.vx))
    assert ctrl3._runner.sim.iteration == 20


def test_periodic_shear_decay():
    """Viscosity from shear-wave decay through the full controller stack
    (mode-resolved; see .claude/skills/verify/SKILL.md)."""
    from sailfish_tpu.controller import LBSimulationController
    from sailfish_tpu.models.single import LBFluidSim
    from sailfish_tpu.subdomain import Subdomain2D

    N, visc, u0 = 32, 0.05, 0.01

    class SW(Subdomain2D):
        def boundary_conditions(self, hx, hy):
            pass

        def initial_conditions(self, sim, hx, hy):
            sim.rho[:] = 1.0
            sim.vx[:] = u0 * np.sin(2 * np.pi * hy / N)

    class SWSim(LBFluidSim):
        subdomain = SW

    ctrl = LBSimulationController(SWSim, default_config=dict(
        lat_nx=N, lat_ny=N, visc=visc, max_iters=400, every=400,
        quiet=True, periodic_x=True, periodic_y=True))
    ctrl.run(ignore_cmdline=True)
    ctrl._runner._fields_to_host()
    vx = ctrl._runner.sim.vx
    k = 2 * np.pi / N
    amp = abs(np.fft.rfft(vx[:, 0])[1]) * 2 / N
    nu = -np.log(amp / u0) / (k * k * 400)
    assert abs(nu - visc) / visc < 0.02, nu


@pytest.mark.slow
def test_viscosity_all_3d_grids():
    """Shear-wave decay through the full step for every 3D lattice:
    measured viscosity from the Fourier-mode amplitude within 1%
    (D3Q13/D3Q15/D3Q19/D3Q27 all recover the same hydrodynamics)."""
    import jax
    import jax.numpy as jnp

    from sailfish_tpu import equilibrium as eq
    from sailfish_tpu import lattice
    from sailfish_tpu.ops.step import StepBuilder
    from sailfish_tpu.subdomain import NodeMaps

    N = 64
    visc = 0.02
    steps = 400
    # D3Q13's tau slope is 2 (its 4th moment sum w cx^2 cy^2 = 1/6, not
    # cs^4); grid.relaxation_time handles this per lattice
    for name in ('D3Q13', 'D3Q15', 'D3Q19', 'D3Q27'):
        grid = lattice.get_grid(name)
        maps = NodeMaps((8, 8, N), 3)
        b = StepBuilder(grid, maps, visc=visc)
        hx = np.arange(N)
        k = 2 * np.pi / N
        u0 = 0.01
        rho = jnp.ones((8, 8, N), jnp.float32)
        uy = jnp.asarray(np.tile(u0 * np.sin(k * hx), (8, 8, 1)),
                         jnp.float32)
        u = jnp.stack([jnp.zeros_like(rho), uy, jnp.zeros_like(rho)])
        f = eq.bgk_equilibrium(grid, rho, u)
        step = b.build()
        run = jax.jit(lambda f, n: jax.lax.fori_loop(
            0, n, lambda i, fc: step(fc, i), f))

        def mode_amp(f):
            _, u_out = eq.macroscopic(grid, b.streamed(f))
            return np.abs(np.fft.rfft(
                np.asarray(u_out[1][4, 4]))[1]) / N

        # two-point fit between t=steps and t=2*steps: the equilibrium
        # initialization sheds a one-time transient that a from-t0 fit
        # would misattribute to viscosity
        f = run(f, steps)
        amp1 = mode_amp(f)
        f = run(f, steps)
        amp2 = mode_amp(f)
        nu = -np.log(amp2 / amp1) / (k * k * steps)
        # D3Q13's residual ghost-mode anisotropy biases it ~0.5%
        tol = 0.01 if name == 'D3Q13' else 0.005
        assert abs(nu - visc) / visc < tol, (name, nu)


@pytest.mark.slow
def test_porous_channel_permeability():
    """The porous-media showcase's Darcy measurement against the exact
    parallel-plate permeability k = H^3 / (12 L_y) with the full-way
    bounce-back wall planes at H = gy - 2 (superficial velocity
    definition; examples/porous_anisotropy.py --geometry=channel)."""
    import sys
    sys.path.insert(0, 'examples')
    from porous_anisotropy import PorousSim
    from sailfish_tpu.controller import LBSimulationController
    from sailfish_tpu.geo import LBGeometry3D

    gy = 34
    ctrl = LBSimulationController(
        PorousSim, LBGeometry3D, default_config=dict(
            lat_nx=16, lat_ny=gy, lat_nz=16, geometry='channel',
            flow_axis='z', max_iters=4000, every=4000, quiet=True,
            accel=1e-6))
    ctrl.run(ignore_cmdline=True)
    k = ctrl._runner.sim.permeability(ctrl._runner)
    H = gy - 2
    k_exact = H ** 3 / 12.0 / gy
    assert abs(k - k_exact) / k_exact < 0.02, (k, k_exact)


@pytest.mark.slow
def test_porous_anisotropy_direction():
    """Grains elongated along z must conduct better along z than x
    (k_z > k_x), the headline result of the showcase study."""
    import sys
    sys.path.insert(0, 'examples')
    from porous_anisotropy import PorousSim
    from sailfish_tpu.controller import LBSimulationController
    from sailfish_tpu.geo import LBGeometry3D

    def k_along(axis):
        ctrl = LBSimulationController(
            PorousSim, LBGeometry3D, default_config=dict(
                lat_nx=32, lat_ny=32, lat_nz=32, porosity=0.75,
                stretch=3.0, flow_axis=axis, max_iters=2500,
                every=2500, quiet=True, seed=7))
        ctrl.run(ignore_cmdline=True)
        return ctrl._runner.sim.permeability(ctrl._runner)

    kz = k_along('z')
    kx = k_along('x')
    assert kz > 1.15 * kx, (kz, kx)


@pytest.mark.parametrize('fimpl', ['guo', 'edm', 'velocity_shift'])
def test_poiseuille_force_implementations(fimpl):
    """All three --force_implementation schemes (reference
    lb_base.py:325-328) produce the analytic parabola at low forcing."""
    from poiseuille import PoiseuilleSim, PoiseuilleSubdomain
    from sailfish_tpu.geo import LBGeometry2D
    N = 32
    ctrl = _run_controller(
        PoiseuilleSim, LBGeometry2D,
        lat_nx=N, lat_ny=N, visc=0.1, max_iters=3000, every=3000,
        quiet=True, wall='halfbb', stationary=True,
        force_implementation=fimpl)
    sim = ctrl._runner.sim
    ref = PoiseuilleSubdomain.velocity_profile(ctrl.config, np.arange(N))
    prof = sim.vy[N // 2, :]
    m = ref > 0
    err = np.max(np.abs(prof[m] - ref[m])) / ref.max()
    assert err < 5e-3, (fimpl, err)


def test_force_implementations_differ_exactly_at_second_order():
    """The three --force_implementation schemes (reference
    sym_force.py:150/:184, relaxation_common.mako:93-121) agree at O(F)
    and differ by an EXACT closed-form O(F^2) population with zero
    mass/momentum moments.  Because feq is quadratic in u, one collision
    step obeys (derivable by expanding feq(u+d)-feq(u)):

        fpost_edm    - fpost_guo = P / (4 tau)
        fpost_vshift - fpost_guo = (tau - 1 + 1/(4 tau)) P

    with P_i = w_i rho [4.5 (c_i.a)^2 - 1.5 a^2].  P has zero 0th/1st
    moments (sum_i w_i c_ia c_ib = delta/3), so for a UNIFORM force all
    three schemes are hydrodynamically identical -- the analytic
    steady-state gate is test_poiseuille_force_implementations; this
    test pins the operator-level O(F^2) relation quantitatively."""
    import jax.numpy as jnp

    from sailfish_tpu import equilibrium as eq
    from sailfish_tpu import lattice
    from sailfish_tpu.ops.step import StepBuilder
    from sailfish_tpu.subdomain import NodeMaps

    grid = lattice.get_grid('D2Q9')
    maps = NodeMaps((16, 16), 2)
    a = np.array([0.03, 0.02])
    rng = np.random.default_rng(0)
    rho = jnp.asarray(1.0 + 0.05 * rng.standard_normal((16, 16)),
                      jnp.float32)
    u = jnp.asarray(0.05 * rng.standard_normal((2, 16, 16)), jnp.float32)
    fs = eq.bgk_equilibrium(grid, rho, u)

    fpost = {}
    tau = None
    for fm in ('guo', 'edm', 'velocity_shift'):
        b = StepBuilder(grid, maps, visc=0.1, body_force=a, force_model=fm)
        tau = b.tau
        fpost[fm] = np.asarray(b._collide(fs, rho, u))

    ca = np.asarray(eq.dot_cu(grid, jnp.asarray(
        a.reshape(2, 1, 1), jnp.float32)))           # (Q, 1, 1)
    w = np.asarray(grid.weights).reshape(-1, 1, 1)
    P = w * np.asarray(rho)[None] * (4.5 * ca ** 2 - 1.5 * np.sum(a ** 2))

    d_edm = fpost['edm'] - fpost['guo']
    d_vs = fpost['velocity_shift'] - fpost['guo']
    scale = np.max(np.abs(P))
    assert scale > 1e-5                       # O(F^2) signal above fp32 eps
    assert np.max(np.abs(d_edm - P / (4 * tau))) < 2e-3 * scale
    assert np.max(np.abs(d_vs - (tau - 1 + 1 / (4 * tau)) * P)) \
        < 2e-3 * scale
    # zero mass/momentum moments: the schemes share the O(F) hydrodynamics
    basis = np.asarray(grid.basis, dtype=np.float64)  # (Q, dim)
    for d in (d_edm, d_vs):
        assert np.max(np.abs(np.sum(d, axis=0))) < 1e-6
        mom = np.einsum('qa,qxy->axy', basis, d.astype(np.float64))
        assert np.max(np.abs(mom)) < 1e-6


def test_dynamic_body_force_constant_matches_static():
    """A DynamicValue body force that happens to be constant in time must
    reproduce the baked-constant run (the per-step force_at evaluation vs
    the force_dev constant; reference lb_base.py:346-352)."""
    from poiseuille import PoiseuilleSim
    from sailfish_tpu.geo import LBGeometry2D
    from sailfish_tpu import node_type as snt

    class DynForceSim(PoiseuilleSim):
        def __init__(self, config):
            # skip PoiseuilleSim.__init__'s constant add_body_force
            super(PoiseuilleSim, self).__init__(config)
            accel = self.subdomain.pressure_grad(config)
            self.add_body_force(snt.DynamicValue(
                0.0, lambda t, _a=accel: _a + 0.0 * t))

    def run(cls):
        ctrl = _run_controller(cls, LBGeometry2D, lat_nx=24, lat_ny=24,
                               visc=0.1, max_iters=200, every=200,
                               quiet=True, wall='halfbb')
        sim = ctrl._runner.sim
        return np.array(sim.vy), np.array(sim.rho)

    vy_d, rho_d = run(DynForceSim)
    vy_s, rho_s = run(PoiseuilleSim)
    assert np.max(np.abs(vy_d - vy_s)) < 1e-7
    assert np.max(np.abs(rho_d - rho_s)) < 1e-7


def test_pulsatile_body_force_womersley():
    """An oscillating DynamicValue body force drives a closed channel;
    the velocity profile matches the analytic Womersley solution
    u = Im[(a0/(i w))(1 - cosh(k y)/cosh(k h)) e^{iwt}], k = sqrt(iw/nu)
    (reference lb_base.py:346-352 accepts time-dependent forces; the
    BC-driven counterpart is the womersley example golden)."""
    import jax.numpy as jnp

    from sailfish_tpu import node_type as snt
    from sailfish_tpu.geo import LBGeometry2D
    from sailfish_tpu.models.base import LBForcedSim
    from sailfish_tpu.models.single import LBFluidSim
    from sailfish_tpu.node_type import NTHalfBBWall
    from sailfish_tpu.subdomain import Subdomain2D

    NY = 18                        # halfbb walls: effective width 16
    OMEGA = 2.0 * np.pi / 600.0    # Womersley alpha = h sqrt(w/nu) = 2.6
    A0 = 1e-5
    VISC = 0.1

    class Channel(Subdomain2D):
        def boundary_conditions(self, hx, hy):
            self.set_node((hy == 0) | (hy == self.gy - 1), NTHalfBBWall)

        def initial_conditions(self, sim, hx, hy):
            sim.rho[:] = 1.0

    class PulsatileForceSim(LBFluidSim, LBForcedSim):
        subdomain = Channel

        @classmethod
        def modify_config(cls, config):
            config.periodic_x = True

        def __init__(self, config):
            super().__init__(config)
            self.add_body_force(snt.DynamicValue(
                lambda t: A0 * jnp.sin(OMEGA * t), 0.0))

    # 3 periods: the startup transient decays as exp(-nu (pi/W)^2 t)
    # (slowest channel mode, W = NY) ~ 2e-3 by t = 1800
    steps = 1800
    ctrl = _run_controller(PulsatileForceSim, LBGeometry2D,
                           lat_nx=8, lat_ny=NY, visc=VISC,
                           max_iters=steps, every=steps, quiet=True)
    sim = ctrl._runner.sim
    prof = np.array(sim.vx[:, 4])

    # NTHalfBBWall nodes are fluid; the no-slip plane sits half a cell
    # beyond them (location=-0.5), so the hydrodynamic half-width is
    # NY/2 (examples/poiseuille.py channel_width convention). A per-node
    # amplitude/phase fit against this h matches to <1%.
    y = np.arange(NY)
    h = NY / 2.0
    yc = y - (NY - 1) / 2.0
    k = np.sqrt(1j * OMEGA / VISC)
    uhat = (A0 / (1j * OMEGA)) * (1.0 - np.cosh(k * yc) / np.cosh(k * h))
    ana = np.imag(uhat * np.exp(1j * OMEGA * steps))
    amp = np.max(np.abs(uhat))
    err = np.max(np.abs(prof - ana)) / amp
    assert err < 0.03, err
