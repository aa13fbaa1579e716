"""The fused stream-and-collide step as a traced JAX function.

Counterpart of the reference's generated CollideAndPropagate kernel
(``templates/models/lb_single_fluid.mako:161-229``: getDist ->
fixMissingDistributions -> getMacro -> precollisionBoundaryConditions ->
relaxate -> propagate). There is no runtime codegen: a ``StepBuilder``
specializes a jittable python function at trace time using the *static*
set of node types / orientations present in the scene, so only the BC
branches actually used are materialized, as dense masked selects that
XLA fuses into the streaming pass.

Update ordering: the state array holds POST-COLLISION distributions; one
step is  gather (pull streaming) -> fix missing -> macro -> BC -> collide.
This is the same operation sequence as the reference kernel, observed half
a cycle later, and it makes the hot loop a single gather-compute pass:
every f_i is read once (from the shifted neighbor), collided once, and
written once -- the shape XLA's loop fusion wants.
Periodic wrap is the natural semantics of jnp.roll; non-periodic domain
edges must be covered by boundary nodes (same contract as the reference's
ghost layer).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from sailfish_tpu import equilibrium as eq
from sailfish_tpu import node_type as nt
from sailfish_tpu.equilibrium import signed_sum
from sailfish_tpu.ops import collide as co


def pull(arr, vec):
    """Value of ``arr`` at x - vec (vec in (cx, cy[, cz]) order), i.e. the
    streaming gather: roll by +vec with (z, y, x) axis order."""
    shifts, axes = [], []
    for a, comp in enumerate(vec):
        if comp:
            shifts.append(int(comp))
            axes.append(arr.ndim - 1 - a)
    return jnp.roll(arr, shifts, axes) if shifts else arr


def sample(arr, vec):
    """Value of ``arr`` at x + vec."""
    return pull(arr, [-int(c) for c in vec])


def global_coord_arrays(shape):
    """Global coordinate arrays ordered (hx, hy[, hz]) for a spatial shape
    in numpy axis order (.., z, y, x)."""
    dim = len(shape)
    grids = np.meshgrid(*[np.arange(n) for n in shape], indexing='ij')
    return tuple(grids[dim - 1 - a] for a in range(dim))


#: Node types with a BC implementation in this engine. A present type
#: outside this set raises at build time -- users porting reference
#: scripts must fail loudly instead of silently getting wrong physics.
_IMPLEMENTED_TYPES = (
    nt._NTFluid, nt._NTGhost, nt._NTUnused, nt._NTPropagationOnly,
    nt.NTHalfBBWall, nt.NTFullBBWall, nt.NTWallTMS, nt.NTSlip,
    nt.NTEquilibriumDensity, nt.NTRegularizedDensity, nt.NTGuoDensity,
    nt.NTZouHeDensity, nt.NTEquilibriumVelocity, nt.NTZouHeVelocity,
    nt.NTRegularizedVelocity, nt.NTGradFreeflow, nt.NTDoNothing,
    nt.NTCopy, nt.NTYuOutflow, nt.NTNeumann, nt.NTLaminarize,
    nt.NTExtendedCopy,
)


class StepBuilder:
    """Builds the single-device step function for a single-fluid model.

    Parameters mirror what the reference assembles into its Mako context
    (subdomain_runner.py:182-248, lb_single.py:52-70): lattice, relaxation
    model, forces, subgrid model, and the encoded node maps.
    """

    def __init__(self, grid, maps, *, model='bgk', visc=None, tau=None,
                 incompressible=False, regularized=False,
                 smagorinsky=0.0, body_force=None, force_model='guo',
                 sc_coupling=0.0, sc_potential='linear',
                 equilibrium='bgk', gravity=0.0,
                 dtype=jnp.float32, storage='fp', mixed_range=None,
                 entropy_tolerance=0.0, alpha_tolerance=1e-10,
                 time_unit=1.0):
        self.sc_coupling = sc_coupling
        self.sc_potential = sc_potential
        self.equilibrium = equilibrium
        self.gravity = gravity
        # ELBM Newton stops (--entropy_tolerance / --alpha_tolerance;
        # reference lb_single.py:43-50,63-66: 0.0 = precision default)
        self.entropy_tolerance = float(entropy_tolerance) if \
            entropy_tolerance > 0.0 else \
            (1e-6 if dtype == jnp.float32 else 1e-10)
        self.alpha_tolerance = float(alpha_tolerance)
        # --dt_per_lattice_time_unit: DynamicValue callables see
        # t = iteration * time_unit (reference lb_base.py:55-57 /
        # boundary.mako:80-83 get_time_from_iteration)
        self.time_unit = float(time_unit)
        from sailfish_tpu import lattice as lat
        self.grid = grid
        self.maps = maps
        self.model = model
        # grid-aware nu -> tau (identical to 3 nu + 1/2 on every
        # 4th-order-isotropic lattice; differs only for D3Q13)
        self.tau = float(tau if tau is not None
                         else grid.relaxation_time(visc))
        self.tau_inv = 1.0 / self.tau
        self.incompressible = incompressible
        self.regularized = regularized
        self.smagorinsky = smagorinsky
        self.body_force = body_force      # None | (dim,) numpy | field
        if force_model not in ('guo', 'edm', 'velocity_shift'):
            raise ValueError(
                f'force_model must be guo, edm or velocity_shift; '
                f'got {force_model!r}')
        self.force_model = force_model
        self.dtype = dtype
        # 16-bit fixed-point distribution storage (--precision=mixed;
        # ops/mixed.py). Math stays fp32; the XLA engine applies the
        # same per-step quantization the fused kernel performs in
        # registers, so both engines stay bit-identical.
        self.storage = storage
        self.mixed = None
        if storage == 'int16':
            if dtype != jnp.float32:
                raise NotImplementedError(
                    'mixed 16-bit storage requires fp32 compute')
            if sc_coupling != 0.0:
                raise NotImplementedError(
                    'mixed 16-bit storage does not cover Shan-Chen '
                    '(phase separation drives O(1) density deviations '
                    'past any useful fixed-point range)')
            if equilibrium != 'bgk':
                raise NotImplementedError(
                    'mixed 16-bit storage covers the standard '
                    f'equilibrium only (got {equilibrium})')
            from sailfish_tpu.ops.mixed import DEFAULT_RANGE, MixedScales
            self.mixed = MixedScales(
                grid, DEFAULT_RANGE if mixed_range is None
                else mixed_range)
        self._prepare_static()

    # -- static (trace-time) preprocessing ----------------------------------

    def _prepare_static(self):
        g = self.grid
        m = self.maps
        tm = m.type_map
        self.present = m.present_types

        implemented = {c.id for c in _IMPLEMENTED_TYPES}
        for tid in self.present:
            if tid not in implemented:
                raise NotImplementedError(
                    f'node type {nt.get_node_type(tid).__name__} has no '
                    'BC implementation in the step engine')

        def mask_of(tids):
            return np.isin(tm, list(tids))

        wet_ids = [t for t in self.present if nt.get_node_type(t).wet_node]
        self.wet_np = mask_of(wet_ids)
        self.has_dry = not bool(self.wet_np.all())

        # (type, orientation) instances for orientation-driven BCs.
        self.bc_instances = []
        for tid in self.present:
            cls = nt.get_node_type(tid)
            if not cls.needs_orientation or cls in (nt.NTFullBBWall,):
                continue
            if cls in (nt.NTHalfBBWall, nt.NTWallTMS):
                continue  # handled via link tags
            sel = tm == tid
            for k in np.unique(m.orientation[sel]):
                if k == 0:
                    continue
                self.bc_instances.append(
                    (tid, int(k), sel & (m.orientation == int(k))))

        self.fullbb_np = (mask_of([nt.NTFullBBWall.id])
                          if nt.NTFullBBWall.id in self.present else None)
        self.halfbb_np = None
        half_ids = [t for t in self.present
                    if nt.get_node_type(t).link_tags]
        if half_ids:
            self.halfbb_np = mask_of(half_ids)
        self.tms_np = (tm == nt.NTWallTMS.id
                       if nt.NTWallTMS.id in self.present else None)
        self.slip_np = None
        if nt.NTSlip.id in self.present:
            self.slip_np = tm == nt.NTSlip.id

        # Device constants.
        dev = {}
        dev['wet'] = jnp.asarray(self.wet_np)
        if self.fullbb_np is not None:
            dev['fullbb'] = jnp.asarray(self.fullbb_np)
        if self.halfbb_np is not None:
            # Per-direction boolean tag planes (bit0 unused).
            tags = m.link_tags
            dev['tags'] = jnp.asarray(
                np.stack([(tags >> i) & 1 for i in range(g.Q)]).astype(bool))
        if self.tms_np is not None:
            dev['tms'] = jnp.asarray(self.tms_np)
        if self.slip_np is not None:
            dev['slip_orient'] = jnp.asarray(m.orientation
                                             * self.slip_np.astype(np.int32))
        needs_params = any(
            nt.get_node_type(t).param_names for t in self.present)
        if needs_params:
            dev['rho_bc'] = jnp.asarray(m.param_rho, dtype=self.dtype)
            dev['vel_bc'] = jnp.asarray(m.param_vel, dtype=self.dtype)
        self.dev = dev
        self.bc_masks_dev = [
            (tid, k, jnp.asarray(sel)) for tid, k, sel in self.bc_instances]
        self.dynamic_dev = [(jnp.asarray(mask), name, exprs)
                            for mask, name, exprs in m.dynamic]
        # Coordinate arrays for space-dependent DynamicValues are built
        # eagerly (outside any trace -- caching trace-time constants leaks
        # tracers) and only when some expression actually needs them.
        # Body forces may be DynamicValues too (reference lb_base.py
        # :346-352): keep the expressions and evaluate them on device at
        # each step's iteration index instead of baking a constant.
        self.force_expr = None
        if self.body_force is not None and (
                isinstance(self.body_force, nt.DynamicValue)
                or any(callable(c) for c in self.body_force)):
            exprs = tuple(self.body_force)
            if len(exprs) != g.dim:
                raise ValueError(
                    f'body force needs {g.dim} components; got {len(exprs)}')
            self.force_expr = exprs

        self._coords_cache = ()
        force_exprs = self.force_expr or ()
        if any(nt.DynamicValue.arity(e) > 1
               for _, _, exprs in m.dynamic for e in exprs) or \
                any(nt.DynamicValue.arity(e) > 1 for e in force_exprs):
            self._coords_cache = tuple(
                jnp.asarray(c, dtype=jnp.int32)
                for c in global_coord_arrays(m.type_map.shape))

        # NTExtendedCopy: static gather maps (reference boundary.mako
        # :525-566, sym.rotate_pos/rotate_dist). For each missing dist d at
        # a node x, read f_{d'}(T x - c_{d'}) where d' is d's direction
        # rotated by the 4x4 affine transformation T.
        self.ext_gathers = []
        if getattr(m, 'extended', None):
            self._build_extended_copy_gathers()

        if self.body_force is not None and self.force_expr is None:
            bf = np.asarray(self.body_force, dtype=np.float64)
            if bf.ndim == 1:
                bf = bf.reshape((g.dim,) + (1,) * len(m.type_map.shape))
            self.force_dev = jnp.asarray(bf, dtype=self.dtype)
        else:
            # dynamic forces are evaluated per step (force_at)
            self.force_dev = None

        if self.model in ('mrt', 'trt'):
            self.mrt_rates = g.mrt_relaxation_rates(self.tau)

    def _build_extended_copy_gathers(self):
        """Precompute (dist, src_dist, dst_flat, src_flat) index arrays for
        every NTExtendedCopy instance. All geometry is static, so the BC
        reduces to a handful of boundary-sized gathers at trace time."""
        g = self.grid
        m = self.maps
        shape = m.type_map.shape
        dim = g.dim
        coords = global_coord_arrays(shape)   # (hx, hy[, hz]) full arrays

        def rotate_dist(i, R3):
            c = np.zeros(3)
            c[:dim] = g.basis[i][:dim]
            t = np.rint(R3 @ c).astype(int)
            for j in range(g.Q):
                cj = np.zeros(3, dtype=int)
                cj[:dim] = g.basis[j][:dim]
                if np.array_equal(cj, t):
                    return j
            raise ValueError(
                'NTExtendedCopy transformation does not map lattice vector '
                f'{g.basis[i]} onto the lattice')

        for mask, T in m.extended:
            T = np.asarray(T, dtype=np.float64)
            R3 = T[:3, :3]
            sel_all = mask & (m.type_map == nt.NTExtendedCopy.id)
            for k in np.unique(m.orientation[sel_all]):
                if k == 0:
                    continue
                sel = sel_all & (m.orientation == int(k))
                if not sel.any():
                    continue
                n = g.orientation_vectors[int(k) - 1]
                unknown = g.unknown_mask(n)
                idx = np.nonzero(sel)
                dst_flat = np.ravel_multi_index(idx, shape)
                # source positions: T @ (x, y, z, 1)
                pos = np.zeros((4, dst_flat.size))
                for a in range(dim):
                    pos[a] = coords[a][idx]
                pos[3] = 1.0
                src_xyz = np.rint(T @ pos)[:dim].astype(np.int64)
                for d in range(g.Q):
                    if not unknown[d]:
                        continue
                    d2 = rotate_dist(d, R3)
                    # read f_{d2} at (T x) - c_{d2}, periodic wrap
                    src = [
                        (src_xyz[a] - int(g.basis[d2][a]))
                        % shape[len(shape) - 1 - a]
                        for a in range(dim)]
                    src_idx = np.ravel_multi_index(
                        tuple(reversed(src)), shape)
                    self.ext_gathers.append(
                        (d, d2, jnp.asarray(dst_flat),
                         jnp.asarray(src_idx)))

    def shard_constants(self, mesh):
        """Re-place the closed-over node-data constants with shardings
        matching the distribution array, so the jit-SPMD partitioner keeps
        all BC work local to each shard."""
        from jax.sharding import NamedSharding, PartitionSpec as P
        from sailfish_tpu.parallel import mesh as pm
        dim = self.grid.dim
        for k, v in list(self.dev.items()):
            self.dev[k] = pm.shard_field(v, mesh, dim)
        self.bc_masks_dev = [(tid, kk, pm.shard_field(m, mesh, dim))
                             for tid, kk, m in self.bc_masks_dev]
        if self.force_dev is not None:
            if any(s == 1 for s in self.force_dev.shape[1:]):
                self.force_dev = jax.device_put(
                    self.force_dev, NamedSharding(mesh, P()))
            else:
                self.force_dev = pm.shard_field(self.force_dev, mesh, dim)

    # -- phases --------------------------------------------------------------

    def feq(self, rho, u):
        """The model's equilibrium distribution (bgk 2nd-order Hermite or
        shallow-water; ELBM uses its own product form in _collide)."""
        if self.equilibrium == 'elbm':
            # --entropic_equilibrium: product form with any collision
            # model (reference lb_single.py:31-34)
            from sailfish_tpu.ops import entropic
            return entropic.elbm_equilibrium(self.grid, rho, u)
        if self.equilibrium == 'shallow_water':
            return eq.shallow_water_equilibrium(self.grid, rho, u,
                                                self.gravity)
        return eq.bgk_equilibrium(self.grid, rho, u,
                                  incompressible=self.incompressible)

    def gather(self, f):
        """Pull streaming: fs_i(x) = f_i(x - c_i)."""
        g = self.grid
        return jnp.stack([pull(f[i], g.basis[i]) for i in range(g.Q)])

    def fix_missing(self, fs, f):
        """Replace distributions whose pull source was not a wet node
        (reference: fixMissingDistributions, kernel_common.mako + link
        tags, boundary.mako:391-416). ``f`` is the current (post-collision)
        state, used for local bounce-back replacements."""
        g = self.grid

        def sampler(vec):
            """The (Q, *S) state sampled at x+vec, periodic wrap."""
            return jnp.stack([sample(f[i], vec) for i in range(g.Q)])
        if self.halfbb_np is not None:
            tags = self.dev['tags']
            fixed = []
            for i in range(g.Q):
                o = int(g.opposite[i])
                fixed.append(jnp.where(tags[i], f[o], fs[i]))
            fs = jnp.stack(fixed)
        self._tms_tg = None
        if self.tms_np is not None:
            # Tamm-Mott-Smith wall (Chikatamarla & Karlin 2013; reference
            # boundary.mako:631-647): target macros from the bounce-filled
            # distributions, then the tagged (missing) links are replaced
            # with the equilibrium at the target values. The matching
            # +feq(tg)-feq(inst) shift happens post-collision
            # (_apply_tms).
            tms = self.dev['tms']
            tg_rho, tg_u = eq.macroscopic(g, fs)
            feq_tg = self.feq(tg_rho, tg_u)
            tags = self.dev['tags']
            fs = jnp.where(tms[None] & tags, feq_tg, fs)
            self._tms_tg = (tg_rho, tg_u)
        if self.ext_gathers:
            # NTExtendedCopy: statically-indexed gathers from the rotated
            # source positions (small boundary-sized scatters).
            flat = fs.reshape(g.Q, -1)
            f_flat = f.reshape(g.Q, -1)
            for d, d2, dst, src in self.ext_gathers:
                flat = flat.at[d, dst].set(f_flat[d2, src])
            fs = flat.reshape(fs.shape)
        for tid, k, mask in self.bc_masks_dev:
            cls = nt.get_node_type(tid)
            n = g.orientation_vectors[k - 1]
            unknown = g.unknown_mask(n)
            if cls is nt.NTDoNothing:
                upd = [jnp.where(mask, f[i], fs[i])
                       if unknown[i] else fs[i] for i in range(g.Q)]
                fs = jnp.stack(upd)
            elif cls is nt.NTCopy:
                # copy the POST-STREAM distributions of the neighbor along
                # the inward normal, missing directions only (reference
                # boundary.mako:575-585): fs_i(x+n) == f_i(x + n - c_i)
                upd = [jnp.where(mask,
                                 sampler(np.asarray(n) - g.basis[i])[i],
                                 fs[i])
                       if unknown[i] else fs[i] for i in range(g.Q)]
                fs = jnp.stack(upd)
            elif cls is nt.NTYuOutflow:
                # 2nd-order extrapolation of POST-STREAM values:
                # f_i(x) = 2 fs_i(x+n) - fs_i(x+2n)  (Yu, Mei & Shyy 2005;
                # reference node_type.py:336-352)
                upd = []
                for i in range(g.Q):
                    if not unknown[i]:
                        upd.append(fs[i])
                        continue
                    v1 = sampler(np.asarray(n) - g.basis[i])[i]
                    v2 = sampler(2 * np.asarray(n) - g.basis[i])[i]
                    upd.append(jnp.where(mask, 2.0 * v1 - v2, fs[i]))
                fs = jnp.stack(upd)
            elif cls is nt.NTNeumann:
                # f_i(t+1, x) = f_opp^c(t, x + c_i) + 6 w_i phi . c_i with
                # phi = u(x + 2n) + 2 * gradient (Junk & Yang 2008;
                # reference node_type.py:353-384). The node acts as the
                # ghost layer; u comes from the fluid node two cells in.
                f2n = sampler(2 * np.asarray(n))
                rho2, u2 = eq.macroscopic(g, f2n)
                grad = jnp.asarray(self.maps.param_scalar,
                                   dtype=self.dtype)
                phi = [u2[a] + 2.0 * grad * int(n[a])
                       for a in range(g.dim)]
                upd = []
                for i in range(g.Q):
                    if not unknown[i]:
                        upd.append(fs[i])
                        continue
                    o = int(g.opposite[i])
                    neigh_opp = sampler(g.basis[i])[o]
                    cphi = sum(float(g.basis[i][a]) * phi[a]
                               for a in range(g.dim))
                    val = neigh_opp + 6.0 * float(g.weights[i]) * cphi
                    upd.append(jnp.where(mask, val, fs[i]))
                fs = jnp.stack(upd)
            elif cls is nt.NTGradFreeflow:
                # Grad's approximation for the unknown distributions from
                # the node's own previous state (rho, u, Pi^neq)
                # (reference node_type.py:286-295, boundary.mako:606-621).
                # The reference stores last step's macro fields + the
                # POST-collision flux tensor in scratch space; here the
                # node's post-collision state f carries the same
                # information: rho/u are collision invariants, so
                # macroscopic(f_post) equals the stored pre-collision
                # macros (absent forcing), and Pi^neq(f_post) is exactly
                # the post-collision flux the reference saves
                # (compute_2nd_moment after relaxate,
                # boundary.mako:696-706). Invariance check: a uniform
                # equilibrium stream passes through unchanged
                # (test_bc_catalog.test_grad_outflow_uniform_stream).
                rho_p, u_p = eq.macroscopic(g, f)
                feq_p = self.feq(rho_p, u_p)
                pi_p = eq.second_moment_noneq(g, f, feq_p)
                fgrad = eq.regularized_f(
                    g, rho_p, u_p, pi_p,
                    incompressible=self.incompressible)
                upd = [jnp.where(mask, fgrad[i], fs[i])
                       if unknown[i] else fs[i] for i in range(g.Q)]
                fs = jnp.stack(upd)
            elif cls is nt.NTLaminarize:
                # Blend toward the mean over the plane perpendicular to
                # the orientation (reference node_type.py:385-399).
                alpha = jnp.asarray(self.maps.param_scalar,
                                    dtype=self.dtype)
                naxis = (k - 1) // 2
                arr_axis = fs.ndim - 1 - naxis  # spatial axis of normal
                perp_axes = tuple(a for a in range(1, fs.ndim)
                                  if a != arr_axis)
                mask_f = mask.astype(fs.dtype)
                num = jnp.sum(fs * mask_f[None], axis=perp_axes,
                              keepdims=True)
                den = jnp.sum(mask_f,
                              axis=tuple(a - 1 for a in perp_axes),
                              keepdims=True)[None]
                mean = num / jnp.maximum(den, 1.0)
                blended = (1.0 - alpha) * fs + alpha * mean
                fs = jnp.where(mask[None], blended, fs)
        return fs

    def bc_params(self, it):
        """Effective (rho_bc, vel_bc) device fields at iteration ``it``,
        with DynamicValue overrides applied (reference DynamicValue /
        time-series machinery, node_type.py:471-626)."""
        rho_bc = self.dev.get('rho_bc')
        vel_bc = self.dev.get('vel_bc')
        if not self.dynamic_dev:
            return rho_bc, vel_bc
        t = jnp.asarray(it, dtype=self.dtype) * self.time_unit
        coords = self._coords_cache
        for mask, name, exprs in self.dynamic_dev:
            vals = [jnp.broadcast_to(
                jnp.asarray(nt.DynamicValue.evaluate(e, t, coords),
                            dtype=self.dtype), mask.shape)
                for e in exprs]
            if name == 'velocity':
                vel_bc = jnp.where(mask[None], jnp.stack(vals), vel_bc)
            elif name == 'density':
                rho_bc = jnp.where(mask, vals[0], rho_bc)
        return rho_bc, vel_bc

    def _solve_macro_bc(self, fs, rho, u, params=None):
        """Apply per-BC macroscopic overrides (reference boundary.mako
        getMacro dispatch :466+; rho/velocity solves follow Zou & He)."""
        g = self.grid
        if params is None:
            params = (self.dev.get('rho_bc'), self.dev.get('vel_bc'))
        rho_bc_eff, vel_bc_eff = params
        fl = [fs[i] for i in range(g.Q)]
        for tid, k, mask in self.bc_masks_dev:
            cls = nt.get_node_type(tid)
            if cls is nt.NTGuoDensity:
                # No macroscopic solve: the whole BC is a post-collision
                # overlay from the neighbor along the normal
                # (_guo_density_overlay). Pin rho for output sanity only.
                if rho_bc_eff is not None:
                    rho = jnp.where(mask, rho_bc_eff, rho)
                continue
            n = g.orientation_vectors[k - 1]
            cn = g.basis @ n                       # (Q,) in {-1,0,1}
            s0 = signed_sum((cn == 0).astype(int), fl)
            sin = signed_sum((cn < 0).astype(int), fl)
            if 'velocity' in cls.param_names:
                u_bc = vel_bc_eff
                un = signed_sum(n, [u_bc[a] for a in range(g.dim)])
                rho_s = (s0 + 2.0 * sin) / (1.0 - un)
                rho = jnp.where(mask, rho_s, rho)
                u = jnp.where(mask[None], u_bc, u)
            elif 'density' in cls.param_names:
                rho_bc = rho_bc_eff
                un = 1.0 - (s0 + 2.0 * sin) / rho_bc
                uvec = jnp.stack([un * int(n[a]) for a in range(g.dim)])
                rho = jnp.where(mask, rho_bc, rho)
                u = jnp.where(mask[None], uvec, u)
        return rho, u

    def _noneq_bb(self, fs, feq, unknown):
        """Replace unknown f_i by f_opp + feq_i - feq_opp (non-equilibrium
        bounce-back; reference sym.noneq_bb, sym.py:750)."""
        g = self.grid
        out = []
        for i in range(g.Q):
            if unknown[i]:
                o = int(g.opposite[i])
                out.append(fs[o] + feq[i] - feq[o])
            else:
                out.append(fs[i])
        return jnp.stack(out)

    def _pre_collision_bc(self, fs, rho, u):
        """Distribution reconstruction at BC nodes
        (reference boundary.mako:322-465)."""
        g = self.grid
        for tid, k, mask in self.bc_masks_dev:
            cls = nt.get_node_type(tid)
            n = g.orientation_vectors[k - 1]
            unknown = g.unknown_mask(n)
            if cls in (nt.NTEquilibriumVelocity, nt.NTEquilibriumDensity):
                feq = self.feq(rho, u)
                fs = jnp.where(mask[None], feq, fs)
            elif cls in (nt.NTZouHeVelocity, nt.NTZouHeDensity):
                feq = self.feq(rho, u)
                fz = self._noneq_bb(fs, feq, unknown)
                # Tangential momentum fixup (reference sym.zouhe_fixup,
                # sym.py:768).
                mom = eq.momentum(g, fz)
                naxis = (k - 1) // 2
                for a in range(g.dim):
                    if a == naxis:
                        continue
                    coeff = np.where(unknown, g.basis[:, a], 0)
                    denom = float(np.sum(coeff * g.basis[:, a]))
                    if denom == 0.0:
                        continue
                    dj = rho * u[a] - mom[a]
                    corr = jnp.stack([
                        (float(coeff[i]) / denom) * dj if coeff[i] else
                        jnp.zeros_like(dj) for i in range(g.Q)])
                    fz = fz + corr
                fs = jnp.where(mask[None], fz, fs)
            elif cls in (nt.NTRegularizedVelocity, nt.NTRegularizedDensity):
                feq = self.feq(rho, u)
                fnb = self._noneq_bb(fs, feq, unknown)
                pi = eq.second_moment_noneq(g, fnb, feq)
                freg = eq.regularized_f(g, rho, u, pi,
                                        incompressible=self.incompressible)
                fs = jnp.where(mask[None], freg, fs)
        return fs

    def force_at(self, it):
        """The device body-force field at iteration ``it``: the baked
        constant, or DynamicValue expressions evaluated on device inside
        the trace (reference lb_base.py:346-352 accepts time/space
        dependent forces)."""
        if self.force_expr is None:
            return self.force_dev
        t = jnp.asarray(it, dtype=self.dtype) * self.time_unit
        coords = self._coords_cache
        shape = self.maps.type_map.shape
        vals = [jnp.asarray(nt.DynamicValue.evaluate(e, t, coords),
                            dtype=self.dtype) for e in self.force_expr]
        if any(v.ndim for v in vals):
            vals = [jnp.broadcast_to(v, shape) for v in vals]
        else:
            vals = [jnp.reshape(v, (1,) * len(shape)) for v in vals]
        return jnp.stack(vals)

    def _collide(self, fs, rho, u, u_eq=None, force=None):
        """``u_eq`` overrides the equilibrium velocity (used by multi-grid
        couplings: common-velocity Shan-Chen, free-energy); ``force``
        overrides the body-force field (the step passes force_at(it) so
        DynamicValue forces see the current iteration)."""
        g = self.grid
        if force is None:
            force = self.force_dev
        tau_inv = self.tau_inv
        if self.smagorinsky > 0.0:
            feq = self.feq(rho, u)
            tau_inv = co.smagorinsky_tau_inv(
                g, fs, feq, rho, self.tau, self.smagorinsky)[None]
        if u_eq is None:
            u_eq = u
        if self.sc_coupling != 0.0:
            # Single-component Shan-Chen pseudopotential multiphase
            # (reference lb_single.LBSingleFluidShanChen, lb_single.py:242):
            # classic velocity-shift forcing u_eq = u + tau F / rho.
            F = co.shan_chen_force(g, rho, rho, self.sc_coupling,
                                   self.sc_potential)
            u_eq = u_eq + self.tau * F / rho[None]
        if force is not None:
            # Equilibrium-velocity handling per --force_implementation
            # (reference relaxation_common.mako:109-133 fluid_velocity):
            # guo shifts by a/2 (forces are ACCELERATIONS,
            # sym_force.py:121-161), velocity_shift by tau*a (Shan-Chen
            # style; the whole force enters through the shift), edm
            # leaves the bare velocity.
            if self.force_model == 'guo':
                u_eq = u_eq + 0.5 * force
            elif self.force_model == 'velocity_shift':
                u_eq = u_eq + self.tau * force
        if self.model in ('mrt', 'trt'):
            fpost = co.mrt_collide(g, fs, rho, u_eq, self.mrt_rates,
                                   incompressible=self.incompressible)
        elif self.model == 'elbm':
            from sailfish_tpu.ops import entropic
            # dry-node collide results are replaced below; keep them
            # out of the Newton convergence vote (entropic_alpha)
            skip = jnp.logical_not(self.dev['wet']) if self.has_dry \
                else None
            fpost, self.last_alpha = entropic.elbm_collide(
                g, fs, rho, u_eq, self.tau, skip=skip,
                entropy_tol=self.entropy_tolerance,
                alpha_tol=self.alpha_tolerance)
        else:
            feq2 = self.feq(rho, u_eq)
            fpost = fs + tau_inv * (feq2 - fs)
        if force is not None:
            if self.force_model == 'guo':
                fpost = fpost + co.guo_force_terms(
                    g, u_eq, force, self.tau_inv, rho)
            elif self.force_model == 'edm':
                fpost = fpost + co.edm_shift(
                    g, rho, u, force,
                    incompressible=self.incompressible)
            # velocity_shift: no post-relaxation term -- the force acts
            # entirely through the tau-scaled equilibrium shift above
            # (reference relaxation_common.mako:93-121 applies no
            # apply_body_force increment for velocity_shift)
        return fpost

    def _post_collision(self, fs, fpost):
        """Dry-node handling: full bounce-back reflection & slip
        (reference via bb_swap_pairs, sym.py:468-533). Operates on the
        freshly gathered distributions fs (the arriving populations)."""
        g = self.grid
        if self.fullbb_np is not None:
            frefl = fs[jnp.asarray(g.opposite)]
            fpost = jnp.where(self.dev['fullbb'][None], frefl, fpost)
        if self.slip_np is not None:
            so = self.dev['slip_orient']
            for k in np.unique(self.maps.orientation[self.slip_np]):
                if k == 0:
                    continue
                axis = (int(k) - 1) // 2
                perm = g.slip_swap(axis)
                fslip = fs[jnp.asarray(perm)]
                fpost = jnp.where((so == int(k))[None], fslip, fpost)
        return fpost

    def _apply_tms(self, fpost, rho, u):
        """Post-collision part of the TMS wall: shift the whole node by
        feq(target) - feq(instantaneous) (reference boundary.mako:696-718).
        The bounce-fill of tagged links at the next step supplies the
        'write opposites back' part of the reference scheme."""
        if getattr(self, '_tms_tg', None) is None:
            return fpost
        tg_rho, tg_u = self._tms_tg
        corr = self.feq(tg_rho, tg_u) - self.feq(rho, u)
        return jnp.where(self.dev['tms'][None], fpost + corr, fpost)

    def _guo_density_overlay(self, fs, fpost, params):
        """Guo's extrapolation density BC (reference relaxation.mako
        :134-175): the boundary node O with inward normal n takes
        f_post(O) = feq(rho_bc, u_B) + (1 - 1/tau) f^neq(B) where B = O+n
        is the fluid neighbor and f^neq is measured on the post-stream
        distributions at B."""
        insts = [(tid, k, mask) for tid, k, mask in self.bc_masks_dev
                 if nt.get_node_type(tid) is nt.NTGuoDensity]
        if not insts:
            return fpost
        g = self.grid
        rho_bc_eff = params[0]
        for tid, k, mask in insts:
            n = np.asarray(g.orientation_vectors[k - 1])
            fsB = sample(fs, n)  # fs_i(x+n), shared periodic shift
            rhoB, uB = eq.macroscopic(g, fsB)
            feqB = self.feq(rhoB, uB)
            val = self.feq(rho_bc_eff, uB) + \
                (1.0 - self.tau_inv) * (fsB - feqB)
            fpost = jnp.where(mask[None], val, fpost)
        return fpost

    def phases(self, fs, f, it=0):
        """The canonical post-gather phase sequence: fix missing -> macro
        -> BC solves -> pre-collision BC -> collide -> dry/post handling
        -> TMS/Guo overlays."""
        fs = self.fix_missing(fs, f)
        rho, u = eq.macroscopic(self.grid, fs)
        params = self.bc_params(it)
        rho, u = self._solve_macro_bc(fs, rho, u, params)
        fs2 = self._pre_collision_bc(fs, rho, u)
        fpost = self._collide(fs2, rho, u, force=self.force_at(it))
        if self.has_dry:
            fpost = jnp.where(self.dev['wet'][None], fpost, fs2)
        fpost = self._post_collision(fs2, fpost)
        fpost = self._apply_tms(fpost, rho, u)
        fpost = self._guo_density_overlay(fs, fpost, params)
        return fpost

    # -- public --------------------------------------------------------------

    def streamed(self, f):
        """The post-streaming distributions at every node (what the
        reference kernel sees after getDist+fixMissing)."""
        return self.fix_missing(self.gather(f), f)

    def macro_fields(self, f, it=0):
        """rho, u for output, with BC overrides applied so boundary values
        are meaningful."""
        fs = self.streamed(f)
        rho, u = eq.macroscopic(self.grid, fs)
        rho, u = self._solve_macro_bc(fs, rho, u, self.bc_params(it))
        force = self.force_at(it)
        if force is not None:
            u = u + 0.5 * force
        return rho, u

    def build(self):
        """Returns step(f) -> f_next (un-jitted; caller jits/shards).
        State = post-collision distributions. With storage='int16' the
        post-collision state is passed through the int16 quantization
        grid every step (quant o dequant is the identity on quantized
        values, so the public fp32 carry is equivalent to an int16
        carry -- see ops/mixed.py)."""

        def step(f, it=0):
            return self.phases(self.gather(f), f, it)

        if self.mixed is None:
            return step
        mx = self.mixed

        def step_mixed(f, it=0):
            return mx.dequant(mx.quant(step(f, it)))

        return step_mixed
