"""Single-fluid models (BGK / MRT / regularized / LES).

API-compatible counterpart of the reference's ``sailfish/lb_single.py``
(LBFluidSim :14, options :21-51). The entropic, free-surface, Shan-Chen
and IBM variants arrive with the model-widening milestones.
"""

from __future__ import annotations

import numpy as np

from sailfish_tpu import lattice
from sailfish_tpu.models.base import LBForcedSim, LBSim, ScalarField, \
    VectorField


class LBFluidSim(LBSim):
    """Single-phase fluid (reference lb_single.py:14-200)."""

    kernel_id = 'fluid'

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--visc', type=float, default=1.0 / 6.0,
                           help='numerical viscosity')
        group.add_argument('--model', type=str, default='bgk',
                           choices=['bgk', 'mrt', 'trt', 'elbm'],
                           help='relaxation model')
        group.add_argument('--subgrid', type=str, default=None,
                           choices=[None, 'none', 'les-smagorinsky'],
                           help='subgrid turbulence model')
        group.add_argument('--smagorinsky_const', type=float, default=0.03,
                           help='Smagorinsky constant')
        group.add_argument('--regularized', action='store_true',
                           default=False,
                           help='regularized dynamics (filter ghost moments)')
        group.add_argument('--incompressible', action='store_true',
                           default=False,
                           help='incompressible (rho0=1) equilibrium')
        group.add_argument('--minimize_roundoff', action='store_true',
                           default=False,
                           help='store f - w (shifted populations)')
        group.add_argument('--entropic_equilibrium', action='store_true',
                           default=False,
                           help='use the product-form (entropic) '
                           'equilibrium instead of the standard LBGK '
                           'one (reference lb_single.py:31-34)')
        group.add_argument('--entropy_tolerance', type=float,
                           default=0.0,
                           help='ELBM: entropy changes below this are '
                           'treated as constant (Newton stop); 0.0 '
                           'selects a precision-dependent default '
                           '(1e-6 single / 1e-10 double)')
        group.add_argument('--alpha_tolerance', type=float,
                           default=1e-10,
                           help='ELBM: alpha stagnation tolerance '
                           'ending the Newton iteration')

    @classmethod
    def fields(cls):
        return [ScalarField('rho'), VectorField('v')]

    def __init__(self, config):
        super().__init__(config)
        grid_name = getattr(config, 'grid', None) or \
            ('D2Q9' if self.dim == 2 else 'D3Q19')
        self.grid = lattice.get_grid(grid_name)
        assert self.grid.dim == self.dim, \
            f'grid {grid_name} does not match dim {self.dim}'
        self.grids = [self.grid]

    @property
    def dim(self):
        return self.subdomain.dim

    # -- field plumbing (runner attaches numpy arrays) -----------------------

    def init_fields(self, shape):
        """Allocate host-side field arrays for initial_conditions.

        shape: (gy, gx) or (gz, gy, gx). Exposes sim.rho / sim.vx / sim.vy
        (/ sim.vz) exactly like the reference (lb_base.py:139)."""
        self.rho = np.ones(shape, dtype=np.float64)
        self.vx = np.zeros(shape, dtype=np.float64)
        self.vy = np.zeros(shape, dtype=np.float64)
        if self.dim == 3:
            self.vz = np.zeros(shape, dtype=np.float64)

    def velocity_components(self):
        comps = [self.vx, self.vy]
        if self.dim == 3:
            comps.append(self.vz)
        return comps

    def host_fields(self):
        """Name -> host array (or component list for vectors); the output
        writer's field registry."""
        return {'rho': self.rho, 'v': self.velocity_components()}

    def make_initial_state(self, builder, dtype):
        """Initial device state: equilibrium at the user-set (rho, u),
        jitted so that no (Q, N) temporaries outlive the fused
        evaluation (a card-filling domain has room for one)."""
        import jax
        import jax.numpy as jnp
        rho = jnp.asarray(self.rho, dtype=dtype)
        u = jnp.asarray(np.stack(self.velocity_components()), dtype=dtype)
        return jax.jit(builder.feq)(rho, u)

    def update_host_fields(self, macro):
        """Copy device macro fields into the host-side numpy arrays."""
        rho, u = macro
        self.rho[...] = np.asarray(rho, dtype=np.float64)
        comps = self.velocity_components()
        for a in range(self.dim):
            comps[a][...] = np.asarray(u[a], dtype=np.float64)

    def step_builder_kwargs(self):
        """Extra StepBuilder arguments contributed by model subclasses."""
        return {}

    def make_step_builder(self, maps, dtype):
        from sailfish_tpu.ops.step import StepBuilder
        cfg = self.config
        body_force = None
        force_model = 'guo'
        if isinstance(self, LBForcedSim):
            bf = self.body_force(0)
            if bf is not None:
                body_force = bf
            force_model = getattr(cfg, 'force_implementation', 'guo')
        smag = 0.0
        if cfg.subgrid == 'les-smagorinsky':
            smag = cfg.smagorinsky_const
        kwargs = self.step_builder_kwargs()
        if cfg.precision == 'mixed':
            kwargs.setdefault('storage', 'int16')
            kwargs.setdefault('mixed_range', cfg.mixed_range)
        if getattr(cfg, 'entropic_equilibrium', False):
            kwargs.setdefault('equilibrium', 'elbm')
        kwargs.setdefault('entropy_tolerance',
                          getattr(cfg, 'entropy_tolerance', 0.0))
        kwargs.setdefault('alpha_tolerance',
                          getattr(cfg, 'alpha_tolerance', 1e-10))
        return StepBuilder(
            self.grid, maps,
            model=cfg.model,
            visc=cfg.visc,
            incompressible=cfg.incompressible,
            regularized=cfg.regularized,
            smagorinsky=smag,
            body_force=body_force,
            force_model=force_model,
            dtype=dtype,
            time_unit=getattr(cfg, 'dt_per_lattice_time_unit', 1.0),
            **kwargs)


class LBForcedFluidSim(LBFluidSim, LBForcedSim):
    """Convenience combination."""


class LBEntropicFluidSim(LBFluidSim):
    """Entropic LBM with alpha tracking (reference lb_single.py:200-217).

    alpha == 2 where the flow is fully resolved; < 2 indicates smoothing,
    > 2 enhancement of perturbations."""

    alpha_output = True

    @classmethod
    def modify_config(cls, config):
        config.model = 'elbm'

    @classmethod
    def fields(cls):
        return [ScalarField('rho'), VectorField('v'),
                ScalarField('alpha', init=2.0)]

    def init_fields(self, shape):
        super().init_fields(shape)
        self.alpha = np.full(shape, 2.0, dtype=np.float64)

    def host_fields(self):
        out = super().host_fields()
        out['alpha'] = self.alpha
        return out

    def update_host_fields(self, macro):
        super().update_host_fields(macro)
        runner = getattr(self, '_runner', None)
        if runner is not None:
            self.alpha[...] = np.asarray(self._alpha_fn(runner.f),
                                         dtype=np.float64)

    def before_main_loop(self, runner):
        """Build the jitted alpha diagnostic (the entropic relaxation
        parameter of the CURRENT state; reference stores it per node as
        alpha_out, entropic.mako:176-183)."""
        import jax

        from sailfish_tpu.ops import entropic
        self._runner = runner
        b = runner.builder

        @jax.jit
        def alpha_of(f):
            fs = b.streamed(f)
            import sailfish_tpu.equilibrium as eqm
            rho, u = eqm.macroscopic(b.grid, fs)
            feq = entropic.elbm_equilibrium(b.grid, rho, u)
            return entropic.entropic_alpha(
                b.grid, fs, feq - fs,
                entropy_tol=b.entropy_tolerance,
                alpha_tol=b.alpha_tolerance)

        self._alpha_fn = alpha_of


class LBFreeSurface(LBFluidSim):
    """Shallow-water ("free surface") LB model
    (reference lb_single.py:219-237)."""

    @classmethod
    def modify_config(cls, config):
        config.grid = 'D2Q9'
        config.model = 'bgk'

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--gravity', type=float, default=0.001,
                           help='gravitational acceleration')

    def step_builder_kwargs(self):
        return {'equilibrium': 'shallow_water',
                'gravity': self.config.gravity}


class Particle:
    """IBM particle tethered to a reference position by a spring
    (reference lb_single.py:406-411)."""

    def __init__(self, position, mass=1.0, stiffness=1.0,
                 ref_position=None):
        self.position = tuple(position)
        self.mass = mass
        self.ref_position = tuple(ref_position if ref_position is not None
                                  else position)
        self.stiffness = stiffness


class LBIBMFluidSim(LBFluidSim, LBForcedSim):
    """Single-phase fluid with immersed-boundary particles
    (reference lb_single.py:350-405)."""

    @classmethod
    def fields(cls):
        return LBFluidSim.fields() + [VectorField('force')]

    def __init__(self, config):
        super().__init__(config)
        self._particles = []

    @property
    def num_particles(self):
        return len(self._particles)

    def add_particle(self, particle):
        assert isinstance(particle, Particle)
        self._particles.append(particle)

    def make_step_builder(self, maps, dtype):
        from sailfish_tpu.ops.ibm import IBMStepBuilder
        cfg = self.config
        bf = self.body_force(0)
        assert self._particles, 'add_particle() before running'
        pos = np.array([p.position for p in self._particles]).T
        ref = np.array([p.ref_position for p in self._particles]).T
        stiff = np.array([p.stiffness for p in self._particles])
        self._initial_positions = pos
        return IBMStepBuilder(
            self.grid, maps,
            ref_positions=ref, stiffness=stiff,
            model='bgk', visc=cfg.visc,
            incompressible=cfg.incompressible,
            body_force=bf, dtype=dtype,
            time_unit=getattr(cfg, 'dt_per_lattice_time_unit', 1.0))

    def make_initial_state(self, builder, dtype):
        import jax.numpy as jnp
        f = super().make_initial_state(builder, dtype)
        return (f, jnp.asarray(self._initial_positions, dtype=dtype))

    def update_host_fields(self, macro):
        super().update_host_fields(macro)

    def particle_positions(self, runner):
        """(dim, Np) numpy particle positions from the device state."""
        return np.asarray(runner.f[1])


class LBSingleFluidShanChen(LBFluidSim, LBForcedSim):
    """Single-component Shan-Chen pseudopotential multiphase model
    (reference lb_single.py:239-320; the reference's NNSubdomainRunner
    macro-field pre-exchange collapses into the same traced step here --
    neighbor densities are one more halo-exchanged gather)."""

    nonlocality = 1

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--G', type=float, default=1.0,
                           help='Shan-Chen interaction strength constant')
        group.add_argument('--sc_potential', type=str,
                           choices=['linear', 'classic'], default='linear',
                           help='Shan-Chen pseudopotential function')

    def step_builder_kwargs(self):
        return {'sc_coupling': self.config.G,
                'sc_potential': self.config.sc_potential}
