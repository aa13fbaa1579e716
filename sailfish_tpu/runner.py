"""Simulation runner: owns device state, the jitted step, and the main loop.

Counterpart of the reference's ``sailfish/subdomain_runner.py`` (:45 class,
:1537 run, :1668 main, :960 step). One JAX process replaces the reference's
process-per-GPU + two-stream + zmq machinery: the whole domain lives in
(optionally sharded) device arrays, the inner loop is a jitted
``lax.fori_loop`` over collide-and-propagate steps with donated buffers (no
host sync between outputs), and on a mesh XLA's SPMD partitioner turns the
streaming shifts into collective permutes (``parallel/mesh.py``).
"""

from __future__ import annotations

import functools
import time

import numpy as np

import jax
import jax.numpy as jnp

from sailfish_tpu import equilibrium as eq
from sailfish_tpu import io as sio
from sailfish_tpu import util
from sailfish_tpu.parallel import mesh as pmesh
from sailfish_tpu.profile import TimeProfile


def window_shifted(plane, window, shift):
    """plane[window - shift] with periodic wrap, built from static slices
    only (reads just the window-sized region). ``window``: python slices
    per axis; ``shift``: source offset in array axis order."""
    out = plane
    for ax, (w, s) in enumerate(zip(window, shift)):
        n = plane.shape[ax]
        lo, hi = w.start - s, w.stop - s
        idx = [slice(None)] * plane.ndim

        def part(a, b):
            idx2 = list(idx)
            idx2[ax] = slice(a, b)
            return out[tuple(idx2)]

        if lo >= 0 and hi <= n:
            out = part(lo, hi)
        elif lo < 0:
            out = jnp.concatenate([part(n + lo, n), part(0, hi)], axis=ax)
        else:  # hi > n
            out = jnp.concatenate([part(lo, n), part(0, hi - n)], axis=ax)
    return out


class SubdomainRunner:
    """Runs one simulation (whole domain; sharded over the mesh)."""

    def __init__(self, sim, geo, output=None, quit_event=None,
                 master_addr=None, summary_addr=None):
        self.sim = sim
        self.config = sim.config
        self.geo = geo
        self._output = output
        self._quit_event = quit_event or util.SimpleEvent()
        self.profile = TimeProfile(self)
        self._timing_infos = []

    # -- initialization ------------------------------------------------------

    def _domain_shape(self):
        cfg = self.config
        if self.sim.dim == 2:
            return (cfg.lat_ny, cfg.lat_nx)
        return (cfg.lat_nz, cfg.lat_ny, cfg.lat_nx)

    def _init_geometry(self):
        shape = self._domain_shape()
        spec = self.geo.subdomains()[0].__class__(
            (0,) * self.sim.dim, tuple(reversed(shape)))
        self._subdomain = self.sim.subdomain(
            shape, spec, self.sim.grid, self.config)
        self._subdomain.reset()
        self.maps = self._subdomain.maps

    def _init_fields(self):
        shape = self._domain_shape()
        self.sim.init_fields(shape)
        args = self._subdomain._get_mgrid()
        self._subdomain.initial_conditions(self.sim, *args)

    def _init_state(self):
        dtype = self.config.dtype
        self.builder = self.sim.make_step_builder(self.maps, dtype)
        if (self.config.precision == 'mixed'
                and getattr(self.builder, 'mixed', None) is None):
            raise NotImplementedError(
                '--precision=mixed covers single-fluid scenes only: '
                'the minority component of a mixture lives at near-'
                'vacuum density where the int16 step is comparable to '
                'the distribution value itself -- measured unusable at '
                'every --mixed_range (8.5-21% surface-tension error, '
                '>10% mass drift; regtest/mixed_multiphase_probe.py). '
                'Use --precision=single')
        self.f = self.sim.make_initial_state(self.builder, dtype)
        if getattr(self.builder, 'mixed', None) is not None:
            # snap the initial state to the int16 grid once, so every
            # run (and any restart) iterates from identical codes
            mx = self.builder.mixed
            self.f = jax.jit(lambda a: mx.dequant(mx.quant(a)))(self.f)
        self.mesh = None
        mesh_shape = pmesh.parse_mesh_shape(
            getattr(self.config, 'mesh', ''), self.sim.dim)
        if mesh_shape is not None:
            self.mesh = pmesh.make_mesh(mesh_shape, self.sim.dim)
            pmesh.validate_divisible(self._domain_shape(), self.mesh)
            self.f = jax.tree.map(
                lambda a: pmesh.shard_dists(a, self.mesh, self.sim.dim),
                self.f)
            self.builder.shard_constants(self.mesh)
        self._step_fn = self.builder.build()
        self._step_loop = None    # a multi-step loop replacing fori_loop
        self.step_kernel = 'xla'
        if jax.default_backend() == 'gpu':
            from sailfish_tpu.ops import fused_bgk
            if not fused_bgk.unsupported(self.builder, self.mesh):
                self._step_fn = fused_bgk.fused_step(self.builder)
                self._step_loop = fused_bgk.fused_loop(self.builder)
                self.step_kernel = 'fused_bgk'
        util.get_logger(self.config).info('step: %s', self.step_kernel)
        self.device_hook_state = ()
        self._make_run_steps()
        self._macro = jax.jit(self.builder.macro_fields)

    def _make_run_steps(self):
        """(Re)build the jitted multi-step loop, weaving in any device
        hooks registered via sim.add_device_hook (per-iteration sampling
        inside the loop; the replacement for the reference's per-step
        after_step calls, subdomain_runner.py:1738-1743)."""
        step = self._step_fn
        hooks = getattr(self.sim, '_device_hooks', [])
        if not hooks:
            loop = self._step_loop
            if loop is None:
                def loop(f, n, it0=0):
                    return jax.lax.fori_loop(
                        0, n, lambda i, fc: step(fc, it0 + i), f)

            self._run_steps = jax.jit(loop, donate_argnums=0)
            return

        fns = tuple(fn for _, fn, _e, _f in hooks)
        self.device_hook_state = tuple(
            jax.tree.map(jnp.asarray, init) for init, _, _e, _f in hooks)
        strides = tuple((e, fi) for _, _, e, fi in hooks)
        all_strided = all(e is not None for e, _ in strides)

        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def run_steps_hooked(f, states, n, it0=0):
            def body(i, val):
                fc, sts = val
                f2 = step(fc, it0 + i)
                # hooks see the iteration count AFTER the step, matching
                # sim.iteration at after_step time in the reference
                it = it0 + i + 1

                def run_hooks(sts):
                    return tuple(fn(f2, s, it)
                                 for fn, s in zip(fns, sts))

                if all_strided:
                    # every hook declared its stride: hoist the hook
                    # calls behind one cond on the OR of the declared
                    # predicates
                    pred = None
                    for e, fi in strides:
                        p = (it >= fi) & (jnp.mod(it, e) == 0)
                        pred = p if pred is None else (pred | p)
                    sts = jax.lax.cond(pred, run_hooks,
                                       lambda s: s, sts)
                else:
                    sts = run_hooks(sts)
                return f2, sts
            return jax.lax.fori_loop(0, n, body, (f, states))

        def run_steps(f, n, it0=0):
            f, self.device_hook_state = run_steps_hooked(
                f, self.device_hook_state, n, it0)
            return f

        self._run_steps = run_steps

    # -- force objects (momentum exchange) -----------------------------------

    def _init_force_objects(self):
        """Precompute boundary-link masks per force object and build the
        jitted momentum-exchange reduction (reference
        subdomain_runner.py:1459-1526, kernel_force_objects.mako).

        F = sum over links (x_f wet, x_f + c_i solid) of
            c_i [ f_i(x_f) + f_opp(i)(x_f + c_i) ]
        on the post-collision state."""
        if not self.sim.force_objects:
            self._force_obj_fn = None
            return
        import sailfish_tpu.node_type as nt
        g = self.sim.grid
        m = self.maps
        dim = self.sim.dim
        wet = np.isin(m.type_map, [t for t in m.present_types
                                   if nt.get_node_type(t).wet_node])
        solid = ~wet
        shape = m.type_map.shape
        obj_specs = []
        for fo in self.sim.force_objects:
            # bbox given in (x, y[, z]); array axes are (.., z, y, x)
            los = tuple(reversed(fo.start))
            his = tuple(reversed(fo.end))
            window = tuple(
                slice(max(lo - 1, 0), min(hi + 2, n))
                for lo, hi, n in zip(los, his, shape))
            masks = {}
            for i in range(1, g.Q):
                vec = g.basis[i]
                sh = tuple(int(-vec[dim - 1 - ax]) for ax in range(dim))
                # solid at x + c_i  <=>  solid shifted by -c_i
                neigh_solid = np.roll(solid, sh, axis=tuple(range(dim)))
                link = (wet & neigh_solid)[window]
                if link.any():
                    masks[i] = jnp.asarray(link)
            obj_specs.append((window, masks))
        self._force_obj_specs = obj_specs

        def force_all(state):
            f = state[0] if isinstance(state, tuple) else state
            out = []
            for window, masks in obj_specs:
                F = [jnp.zeros((), f.dtype) for _ in range(dim)]
                for i, link in masks.items():
                    o = int(g.opposite[i])
                    vec = g.basis[i]
                    sh = tuple(int(vec[dim - 1 - ax]) for ax in range(dim))
                    f_out = f[i][window]
                    f_in = window_shifted(f[o], window,
                                          tuple(-s for s in sh))
                    contrib = jnp.sum(jnp.where(link, f_out + f_in, 0.0))
                    for a in range(dim):
                        c = int(vec[a])
                        if c:
                            F[a] = F[a] + c * contrib
                out.append(jnp.stack(F))
            return jnp.stack(out)

        self._force_obj_fn = jax.jit(force_all)

    def update_force_objects(self):
        """(reference subdomain_runner.py:1512-1526)"""
        if getattr(self, '_force_obj_fn', None) is None:
            return
        forces = np.asarray(self._force_obj_fn(self.f))
        for fo, F in zip(self.sim.force_objects, forces):
            fo._force = F

    # -- output & checkpoint -------------------------------------------------

    def _fields_to_host(self):
        self.sim.update_host_fields(self._macro(self.f, self.sim.iteration))

    def _output_fields(self):
        self._fields_to_host()
        if self._output is not None:
            self._output.save(self.sim.iteration)

    def save_checkpoint(self):
        """Checkpoint = distributions + complete pickled sim state (mixin
        accumulators, tracers, ...) + device-hook states (reference
        subdomain_runner.py:1414-1431 pickles sim state the same way)."""
        import pickle
        fname = sio.checkpoint_filename(
            self.config.checkpoint_file,
            sio.filename_iter_digits(self.config.max_iters), 0,
            self.sim.iteration)
        data = {'state': np.array([self.sim.iteration], dtype=np.int64)}
        data['sim_state'] = np.frombuffer(
            pickle.dumps(self.sim.get_state()), dtype=np.uint8)
        leaves = jax.tree.leaves(self.f)
        for i, leaf in enumerate(leaves):
            data[f'dist{i}a'] = np.asarray(leaf)
        hook_leaves = jax.tree.leaves(self.device_hook_state)
        for i, leaf in enumerate(hook_leaves):
            data[f'hook{i}'] = np.asarray(leaf)
        np.savez(fname, **data)

    def restore_checkpoint(self, fname):
        """(reference subdomain_runner.py:1433-1448)"""
        import pickle
        cpoint = np.load(fname, allow_pickle=True)
        if 'sim_state' in cpoint:
            self.sim.set_state(
                pickle.loads(cpoint['sim_state'].tobytes()))
        else:
            self.sim.iteration = int(cpoint['state'][0])
        if not getattr(self.config, 'restore_time', True):
            # --norestore_time: keep the state, restart the clock
            # (reference subdomain_runner.py:1438-1440)
            self.sim.iteration = 0
        leaves, treedef = jax.tree.flatten(self.f)
        new_leaves = [jnp.asarray(cpoint[f'dist{i}a'],
                                  dtype=self.config.dtype)
                      for i in range(len(leaves))]
        self.f = jax.tree.unflatten(treedef, new_leaves)
        if getattr(self.builder, 'mixed', None) is not None:
            # a mixed-mode checkpoint is already on the int16 grid
            # (identity here); a single-precision one restored into a
            # mixed run gets snapped once
            mx = self.builder.mixed
            self.f = jax.jit(lambda a: mx.dequant(mx.quant(a)))(self.f)
        # device-hook states are registered in before_main_loop (after
        # restore); stash the leaves for overlay once hooks exist
        self._pending_hook_leaves = [
            cpoint[k] for k in sorted(
                (k for k in cpoint.files if k.startswith('hook')),
                key=lambda s: int(s[4:]))]

    # -- main loop -----------------------------------------------------------

    def _consistent_init(self):
        """--init_iters consistent initialization (reference
        controller.py:312-315, subdomain_runner.py:1625-1652,
        kernel_common.mako:227-231): run N LBM steps at nu=1/6 with
        the iteration pinned to 0 so the density field relaxes to a
        pressure distribution consistent with the initial velocity
        field, then rebuild the state as feq(rho_relaxed, u_IC) --
        the velocity field is held at the user initial conditions,
        exactly as the reference's initialization kernels skip the
        velocity writeback."""
        n = int(getattr(self.config, 'init_iters', 0) or 0)
        if n <= 0:
            return
        from sailfish_tpu.ops.step import StepBuilder
        if type(self.builder) is not StepBuilder:
            raise NotImplementedError(
                '--init_iters covers single-fluid scenes only '
                f'(got {type(self.builder).__name__})')
        if getattr(self.builder, 'mixed', None) is not None:
            raise NotImplementedError(
                '--init_iters does not combine with mixed int16 '
                'storage; initialize at --precision=single')
        log = util.get_logger(self.config)
        log.info('Consistent initialization started (%d iterations '
                 'at nu=1/6).', n)
        visc = self.config.visc
        self.config.visc = 1.0 / 6.0
        try:
            init_b = self.sim.make_step_builder(self.maps,
                                                self.config.dtype)
            if self.mesh is not None:
                init_b.shard_constants(self.mesh)
            step = init_b.build()

            @jax.jit
            def warmup(f):
                # iteration pinned to 0 (time-dependent BCs see t=0)
                return jax.lax.fori_loop(
                    0, n, lambda i, fc: step(fc, 0), f)

            f_rel = warmup(self.f)
            (rho, _u) = init_b.macro_fields(f_rel)
            u_ic = jnp.asarray(
                np.stack(self.sim.velocity_components()),
                dtype=self.config.dtype)
            if self.mesh is not None:
                u_ic = pmesh.shard_dists(u_ic, self.mesh, self.sim.dim)
            self.f = jax.jit(self.builder.feq)(rho, u_ic)
            jax.block_until_ready(self.f)
        finally:
            self.config.visc = visc
        log.info('Initialization phase complete.')

    def run(self):
        self._init_geometry()
        self._init_fields()
        self._init_state()
        if not self.config.restore_from:
            self._consistent_init()
        self._init_force_objects()
        if self._output is not None:
            # node-type map in every output: post-processing tools (wss,
            # masking) need to distinguish wall/BC nodes from fluid
            self._output.register_field(self.maps.type_map, 'node_type')
            if getattr(self.config, 'debug_dump_node_type_map', False):
                # --debug_dump_node_type_map escape (reference
                # subdomain_runner.py:356-357)
                self._output.dump_node_type(self.maps.type_map)
        if self.config.restore_from:
            self.restore_checkpoint(
                sio.resolve_checkpoint(self.config.restore_from))
        self.sim.before_main_loop(self)
        for hook in self.sim._mixin_before_main_loop:
            hook(self.sim, self)
        if getattr(self.sim, '_device_hooks', []):
            # hooks are typically registered in before_main_loop; weave
            # them into the jitted loop now
            self._make_run_steps()
            pending = getattr(self, '_pending_hook_leaves', None)
            if pending:
                leaves, treedef = jax.tree.flatten(self.device_hook_state)
                assert len(pending) == len(leaves), \
                    'checkpoint device-hook state does not match the ' \
                    'registered hooks'
                self.device_hook_state = jax.tree.unflatten(
                    treedef, [jnp.asarray(p, dtype=l.dtype)
                              for p, l in zip(pending, leaves)])
        trace_dir = getattr(self.config, 'profile_trace', '')
        if trace_dir:
            # device-level tracing (the counterpart of the reference's
            # CUDA-event phase brackets, profile.py:122-132): writes an
            # XPlane/TensorBoard trace with per-kernel device timing
            with jax.profiler.trace(trace_dir):
                return self.main()
        return self.main()

    def _block_until_ready(self):
        jax.block_until_ready(self.f)

    def _install_sighup_checkpoint(self):
        """SIGHUP forces an on-demand checkpoint (reference
        subdomain_runner.py:1528-1535; used with PBS preemption,
        utils/pbs_checkpoint.sh)."""
        import signal
        import threading
        if threading.current_thread() is not threading.main_thread():
            return
        if not self.config.checkpoint_file:
            return

        def handler(signum, frame):
            self._checkpoint_requested = True

        try:
            signal.signal(signal.SIGHUP, handler)
        except (ValueError, OSError):
            pass

    def main(self):
        cfg = self.config
        sim = self.sim
        log = util.get_logger(cfg)
        self._checkpoint_requested = False
        self._interval_warned = False
        self._install_sighup_checkpoint()
        total_nodes = int(np.prod(self._domain_shape()))
        bench_t0 = None
        bench_iters0 = 0
        bench_samples = []
        t_start = time.time()
        mlups_history = []
        if cfg.check_invalid_results_gpu:
            # device-side NaN/Inf gate, evaluated once per chunk (the
            # analog of the reference's in-kernel check,
            # kernel_common.mako:203-211, at chunk granularity)
            @jax.jit
            def _check_finite(f):
                leaves = jax.tree.leaves(f)
                ok = jnp.bool_(True)
                for leaf in leaves:
                    ok = ok & jnp.all(jnp.isfinite(leaf))
                return ok
            self._check_finite = _check_finite

        while sim.iteration < cfg.max_iters:
            if self._quit_event.is_set():
                break
            # how many steps until the next host interaction
            remaining = cfg.max_iters - sim.iteration
            chunk = cfg.every if cfg.every > 0 else remaining
            if cfg.every > 0:
                # stay aligned to output boundaries even when a checkpoint
                # chunk desynchronized the iteration count
                chunk = min(chunk, cfg.every - sim.iteration % cfg.every)
            interval = getattr(sim, 'after_step_interval', None)
            if interval:
                # explicit host-hook cadence contract (see
                # LBSim.after_step_interval)
                if not self._interval_warned and \
                        cfg.every > 0 and interval < cfg.every:
                    log.warning(
                        'after_step_interval=%d caps step chunks below '
                        'every=%d; prefer add_device_hook for '
                        'per-iteration sampling', interval, cfg.every)
                    self._interval_warned = True
                chunk = min(chunk, interval - sim.iteration % interval)
            if cfg.checkpoint_every > 0:
                to_cp = cfg.checkpoint_every - (
                    sim.iteration % cfg.checkpoint_every)
                chunk = min(chunk, to_cp)
            if cfg.mode == 'benchmark' and cfg.benchmark_minibatch > 0 \
                    and sim.iteration >= cfg.benchmark_sample_from:
                # sample MLUPS in minibatches for the sigma report
                # (reference --benchmark_minibatch protocol)
                chunk = min(chunk, cfg.benchmark_minibatch)
            chunk = max(1, min(chunk, remaining))
            t0 = time.time()
            self.f = self._run_steps(self.f, chunk, sim.iteration)
            self._block_until_ready()
            t1 = time.time()
            self.profile.record(TimeProfile.COMP, t1 - t0)
            sim.iteration += chunk
            mlups = total_nodes * chunk / (t1 - t0) / 1e6
            mlups_history.append(mlups)
            if cfg.mode == 'benchmark' and \
                    sim.iteration >= cfg.benchmark_sample_from:
                if bench_t0 is None:
                    bench_t0 = t1
                    bench_iters0 = sim.iteration
                else:
                    bench_samples.append(mlups)
            if cfg.check_invalid_results_gpu and \
                    not bool(self._check_finite(self.f)):
                log.error('invalid results (NaN/Inf) on device at '
                          'iteration %d; aborting', sim.iteration)
                break
            if not cfg.quiet and cfg.perf_stats_every > 0 and \
                    (sim.iteration % cfg.perf_stats_every) < chunk:
                log.info('iteration:%d speed:%.2f MLUPS',
                         sim.iteration, mlups)
            if sim.need_output():
                with self.profile.phase(TimeProfile.SYNC):
                    self._fields_to_host()
                with self.profile.phase(TimeProfile.OUTPUT):
                    if self._output is not None:
                        self._output.save(sim.iteration)
                        if getattr(cfg, 'debug_dump_dists', False):
                            # --debug_dump_dists escape (reference
                            # subdomain_runner.py:1680-1684): the raw
                            # distribution state, one file per event
                            self._output.dump_dists(
                                jax.tree.leaves(self.f), sim.iteration)
                if getattr(self, '_vis', None) is not None:
                    self._vis.update(sim.iteration)
                if cfg.check_invalid_results_host:
                    if not np.all(np.isfinite(self.sim.rho)):
                        log.error('invalid results (NaN/Inf) detected; '
                                  'aborting')
                        break
            sim.after_step(self)
            for hook in sim._mixin_after_step:
                hook(sim, self)
            if sim.need_checkpoint() or self._checkpoint_requested:
                self._checkpoint_requested = False
                with self.profile.phase(TimeProfile.CHECKPOINT):
                    self.save_checkpoint()

        if cfg.mode == 'benchmark':
            self.profile.summary(total_nodes, sim.iteration, log)
            if len(bench_samples) > 1:
                log.info('MLUPS minibatches: mean=%.1f std=%.1f n=%d',
                         float(np.mean(bench_samples)),
                         float(np.std(bench_samples)),
                         len(bench_samples))
        if cfg.final_checkpoint and cfg.checkpoint_file:
            self.save_checkpoint()
        if cfg.output and cfg.every <= 0:
            self._output_fields()
        if self._output is not None:
            self._output.close()
        elapsed = time.time() - t_start
        result = util.TimingInfo(
            iters=sim.iteration, elapsed=elapsed,
            mlups=np.mean(mlups_history[1:]) if len(mlups_history) > 1
            else (mlups_history[0] if mlups_history else 0.0))
        if bench_t0 is not None and sim.iteration > bench_iters0:
            result = util.TimingInfo(
                iters=sim.iteration, elapsed=elapsed,
                mlups=total_nodes * (sim.iteration - bench_iters0)
                / (time.time() - bench_t0) / 1e6)
        self.timing = result
        return result
