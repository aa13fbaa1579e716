#!/usr/bin/env python
"""Smoke test of the main path on NVIDIA GPUs; no CPU fallback.

Run from the repository root:

    python chip_smoke.py          # one card, phases (a)-(f)
    python chip_smoke.py --four   # four cards: the mesh path only

One card:
  (a) the card's name and power limit (nvidia-smi, in a child process
      that stays off JAX) and JAX's devices; fails unless the platform
      is ``gpu``.
  (b) D3Q19 BGK lid-driven cavity at 256^3 through
      ``LBSimulationController.run()`` in benchmark mode: MLUPS,
      compile seconds, peak device memory; fields must be finite.
  (c) the same scene at 512^3 for 20 steps: peak device memory (whether
      XLA holds more than two copies of the 10.2 GB state).
  (d) the XLA engine against the independent numpy D3Q19 BGK step below
      (periodic wrap, full bounce-back) on a seeded 64^3 box with 10%
      solid nodes, 50 steps, fp32, ``atol`` 1e-5; the same for the fused
      kernel (``ops/fused_bgk.py``) that the runner picks for that scene.
  (e) the 41 golden example scenes (``tests/goldens``) in this process
      at the harness's 20 iterations against their CPU goldens, ``rtol``
      1e-5, ``atol`` 1e-6 (the ELBM scene's fields: see GOLDEN_TOL).
  (f) the fused kernel against the XLA step on that scene at 256^3:
      agreement after 20 steps and MLUPS of both, in turns.

Four cards (``--four``): LDC 3D at 256x256x1024 for 100 steps on
``--mesh=4`` (z) and ``--mesh=2x2`` (z, y) against the same domain on one
card, ``atol`` 1e-6 on the macro fields of wet nodes; state and node-map
constants must be spread over 4 devices; prints peak memory per device
and the collective-permute ops of a short trace.

Any failure exits non-zero. The last line of standard output is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

import argparse
import gc
import importlib.util
import json
import os
import runpy
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(REPO, 'examples')
for _p in (REPO, EXAMPLES):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sailfish_tpu import node_type as nt  # noqa: E402
from sailfish_tpu import util  # noqa: E402
from sailfish_tpu.controller import LBSimulationController  # noqa: E402
from sailfish_tpu.models.single import LBFluidSim  # noqa: E402
from sailfish_tpu.subdomain import Subdomain3D  # noqa: E402

# -- the independent reference ----------------------------------------------

#: D3Q19 velocities (cx, cy, cz) and weights, written out here rather than
#: taken from sailfish_tpu.lattice so that the reference shares no code
#: with the engine; states are matched by velocity vector, not by index.
D3Q19_C = np.array(
    [(0, 0, 0)]
    + [v for a in range(3) for v in (tuple(int(a == b) for b in range(3)),
                                     tuple(-int(a == b) for b in range(3)))]
    + [(i, j, 0) for i in (1, -1) for j in (1, -1)]
    + [(i, 0, k) for i in (1, -1) for k in (1, -1)]
    + [(0, j, k) for j in (1, -1) for k in (1, -1)])
D3Q19_W = np.array([1 / 3] + [1 / 18] * 6 + [1 / 36] * 12)
D3Q19_OPP = np.array([int(np.nonzero((D3Q19_C == -c).all(1))[0][0])
                      for c in D3Q19_C])


def reference_step(f, solid, tau):
    """One D3Q19 BGK step of a post-collision state ``f`` (19, Z, Y, X) in
    float64: pull streaming with periodic wrap, BGK relaxation at fluid
    nodes, full bounce-back (the arriving populations reversed) at
    ``solid`` nodes."""
    fs = np.stack([np.roll(f[i], (c[2], c[1], c[0]), axis=(0, 1, 2))
                   for i, c in enumerate(D3Q19_C)])
    rho = fs.sum(0)
    u = np.einsum('qa,q...->a...', D3Q19_C.astype(np.float64), fs) / rho
    cu = np.einsum('qa,a...->q...', D3Q19_C.astype(np.float64), u)
    usq = (u * u).sum(0)
    feq = D3Q19_W[:, None, None, None] * rho * (
        1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq)
    return np.where(solid, fs[D3Q19_OPP], fs + (feq - fs) / tau)


def engine_order(grid):
    """Index into the engine's Q axis for each reference direction."""
    return np.array([int(np.nonzero((grid.basis == c).all(1))[0][0])
                     for c in D3Q19_C])


class SolidBox(Subdomain3D):
    """Periodic box with a seeded random field of full bounce-back nodes,
    so that only fluid and full bounce-back nodes occur."""

    solid_fraction = 0.1
    seed = 7

    def boundary_conditions(self, hx, hy, hz):
        rng = np.random.default_rng(self.seed)
        self.set_node(rng.random(hx.shape) < self.solid_fraction,
                      nt.NTFullBBWall)

    def initial_conditions(self, sim, hx, hy, hz):
        rng = np.random.default_rng(self.seed + 1)
        sim.rho[:] = 1.0 + 0.01 * rng.standard_normal(hx.shape)
        for v in (sim.vx, sim.vy, sim.vz):
            v[:] = 0.02 * rng.standard_normal(hx.shape)


class SolidBoxSim(LBFluidSim):
    subdomain = SolidBox

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({'grid': 'D3Q19', 'visc': 0.05})

    @classmethod
    def modify_config(cls, config):
        config.periodic_x = config.periodic_y = config.periodic_z = True


def solid_box_runner(n, **cfg):
    """A SubdomainRunner of SolidBoxSim at n^3 holding its initial state,
    built through the controller."""
    ctrl = LBSimulationController(SolidBoxSim, default_config=dict(
        lat_nx=n, lat_ny=n, lat_nz=n, max_iters=0, quiet=True, **cfg))
    ctrl.run(ignore_cmdline=True)
    return ctrl._runner


def xla_loop(builder):
    """StepBuilder's XLA step in a jitted loop, like the runner's."""
    step = builder.build()
    return jax.jit(lambda f, n: jax.lax.fori_loop(
        0, n, lambda i, a: step(a, i), f))


def compare_with_reference(n, steps):
    """Max |engine - reference| over all distributions after ``steps``
    steps on the SolidBox scene at n^3, for StepBuilder's XLA step and
    for the runner's jitted loop (the fused kernel on a GPU); keyed by
    step kind."""
    r = solid_box_runner(n)
    order = engine_order(r.sim.grid)
    solid = r.maps.type_map == nt.NTFullBBWall.id
    f_ref = np.asarray(r.f, dtype=np.float64)[order]
    out = {'xla': np.asarray(xla_loop(r.builder)(r.f, steps))}
    out[r.step_kernel] = np.asarray(r._run_steps(r.f, steps, 0))
    for _ in range(steps):
        f_ref = reference_step(f_ref, solid, r.builder.tau)
    return {k: float(np.abs(v[order] - f_ref).max())
            for k, v in out.items()}


# -- device and card ------------------------------------------------------


def result_line(devices):
    d = devices[0]
    return json.dumps({'ok': True, 'device': {
        'platform': d.platform, 'kind': d.device_kind,
        'count': len(devices)}})


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling."""

    def __init__(self):
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **kwargs):
        if event.startswith('/jax/core/compile/'):
            self.seconds += duration


def peak_bytes(device):
    return int(device.memory_stats()['peak_bytes_in_use'])


def all_finite(tree):
    return all(bool(jnp.isfinite(a).all()) for a in jax.tree.leaves(tree))


# -- phases -----------------------------------------------------------------


def run_ldc(nx, ny, nz, iters, every, sample_from, mesh=''):
    from ldc_3d import LDCSim
    ctrl = LBSimulationController(LDCSim, default_config=dict(
        lat_nx=nx, lat_ny=ny, lat_nz=nz, max_iters=iters, every=every,
        mode='benchmark', benchmark_sample_from=sample_from,
        benchmark_minibatch=every, quiet=True, mesh=mesh))
    timing = ctrl.run(ignore_cmdline=True)
    return ctrl._runner, timing


def phase_ldc_256(card, clock):
    c0 = clock.seconds
    t0 = time.perf_counter()
    r, timing = run_ldc(256, 256, 256, iters=400, every=100,
                        sample_from=100)
    wall = time.perf_counter() - t0
    if not all_finite(r.f):
        raise AssertionError('LDC 256^3: non-finite distributions')
    rho, u = r._macro(r.f, r.sim.iteration)
    if not (all_finite(rho) and all_finite(u)):
        raise AssertionError('LDC 256^3: non-finite macro fields')
    dev = jax.devices()[0]
    print(f'(b) LDC D3Q19 256^3 fp32 ({r.step_kernel} step), '
          f'{r.sim.iteration} steps: '
          f'{timing.mlups:.1f} MLUPS over steps 100-400, compile '
          f'{clock.seconds - c0:.2f} s, wall {wall:.1f} s, '
          f'peak_bytes_in_use {peak_bytes(dev)} [{card}]')


def phase_ldc_512(card):
    r, _ = run_ldc(512, 512, 512, iters=20, every=20, sample_from=0)
    if not all_finite(r.f):
        raise AssertionError('LDC 512^3: non-finite distributions')
    state = sum(a.nbytes for a in jax.tree.leaves(r.f))
    print(f'(c) LDC D3Q19 512^3 fp32, 20 steps: peak_bytes_in_use '
          f'{peak_bytes(jax.devices()[0])}, one state copy {state} bytes '
          f'[{card}]')


def phase_reference(card, n=64, steps=50, atol=1e-5):
    # atol: the engine runs fp32 and the GPU sums in another order than
    # numpy; distributions are O(1/3). No matrix product is on this path.
    for kind, err in compare_with_reference(n, steps).items():
        print(f'(d) {kind} step vs numpy reference, D3Q19 BGK + full '
              f'bounce-back {n}^3, {steps} steps: max |diff| {err:.3e} '
              f'(atol {atol}) [{card}]')
        if not err <= atol:
            raise AssertionError(f'{kind}: reference mismatch {err:.3e}')


def phase_fused(card, n=256, steps=200, atol=1e-5):
    """The fused kernel against StepBuilder's XLA step on the SolidBox
    scene: agreement after 20 steps, then MLUPS in turns."""
    r = solid_box_runner(n)
    if r.step_kernel != 'fused_bgk':
        raise AssertionError(f'SolidBox runs {r.step_kernel!r}')
    f0 = np.asarray(r.f)
    loops = {'xla': xla_loop(r.builder),
             'fused_bgk': lambda f, k: r._run_steps(f, k, 0)}
    a, b = (np.asarray(loops[k](jnp.asarray(f0), 20)) for k in loops)
    err = float(np.abs(a - b).max())
    mlups = {k: [] for k in loops}
    for k in ('xla', 'fused_bgk', 'fused_bgk', 'xla'):
        f = loops[k](jnp.asarray(f0), 10)
        jax.block_until_ready(f)
        for _ in range(3):
            t0 = time.perf_counter()
            f = loops[k](f, steps)
            jax.block_until_ready(f)
            mlups[k].append(n ** 3 * steps
                            / (time.perf_counter() - t0) / 1e6)
    for k, v in mlups.items():
        print(f'(f) {k} step, D3Q19 BGK periodic box {n}^3 with 10% '
              f'solids: MLUPS {sorted(v)} median {np.median(v):.1f} '
              f'[{card}]')
    print(f'(f) fused_bgk vs xla after 20 steps: max |diff| {err:.3e} '
          f'(atol {atol}) [{card}]')
    if not err <= atol:
        raise AssertionError(f'fused kernel differs from XLA: {err:.3e}')


def load_harness():
    spec = importlib.util.spec_from_file_location(
        'examples_harness', os.path.join(REPO, 'tests',
                                         'examples_harness.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_golden(harness, name, flags, out_dir):
    """Run one example script in this process as the harness runs it in
    a child, and return its output fields."""
    tag = name.replace('/', '_').replace('.py', '')
    out_base = os.path.join(out_dir, tag)
    path = os.path.join(EXAMPLES, name)
    argv, cwd, path0 = sys.argv, os.getcwd(), list(sys.path)
    sys.argv = [path, f'--max_iters={harness.ITERS}',
                f'--every={harness.ITERS}', '--seed=1234', '--quiet',
                f'--output={out_base}'] + list(flags)
    sys.path.insert(0, os.path.dirname(path))
    os.chdir(EXAMPLES)
    try:
        np.random.seed(1234)
        runpy.run_path(path, run_name='__main__')
    finally:
        sys.argv, sys.path[:] = argv, path0
        os.chdir(cwd)
        util.reset_logger()
    return dict(np.load(f'{out_base}.0.{harness.ITERS:07d}.npz'))


#: Fields whose agreement with the CPU golden is bounded by more than
#: fp32 summation order, with their (rtol, atol). The entropic (ELBM)
#: collision solves for alpha with a Newton iteration that stops at an
#: entropy tolerance of 1e-6 in fp32 (StepBuilder.entropy_tolerance),
#: and the GPU's log differs from the CPU's in the last bits, so the two
#: stop on different iterates. alpha itself is ill-conditioned where the
#: non-equilibrium part is tiny (it multiplies that part), so it differs
#: most while moving the distributions least. Measured on one H100 after
#: 20 steps: rho 1.7e-5 relative, alpha 6.6e-3 relative, vx and vy
#: 1.4e-5 and 8.9e-6 absolute (0.014% of the 0.1 lid speed).
GOLDEN_TOL = {('ldc_2d_entropic', 'rho'): (5e-5, 1e-6),
              ('ldc_2d_entropic', 'alpha'): (1e-2, 1e-6),
              ('ldc_2d_entropic', 'vx'): (1e-5, 5e-5),
              ('ldc_2d_entropic', 'vy'): (1e-5, 5e-5)}


def phase_goldens(card, rtol=1e-5, atol=1e-6):
    harness = load_harness()
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, flags in harness.EXAMPLES.items():
            tag = name.replace('/', '_').replace('.py', '')
            t0 = time.perf_counter()
            golden = np.load(os.path.join(REPO, 'tests', 'goldens',
                                          tag + '.npz'))
            try:
                data = run_golden(harness, name, flags, tmp)
                worst = 0.0
                for k in golden.keys():
                    k_rtol, k_atol = GOLDEN_TOL.get((tag, k), (rtol, atol))
                    np.testing.assert_allclose(data[k], golden[k],
                                               rtol=k_rtol, atol=k_atol,
                                               err_msg=f'{tag}:{k}')
                    worst = max(worst, float(
                        np.abs(data[k] - golden[k]).max()))
                status = f'ok, max |diff| {worst:.2e}'
            except Exception as e:  # report every scene, then fail
                failures.append(tag)
                status = 'FAIL ' + ' '.join(str(e).split())[:300]
            print(f'(e) golden {tag}: {status} '
                  f'({time.perf_counter() - t0:.1f} s) [{card}]',
                  flush=True)
    if failures:
        raise AssertionError(f'golden mismatch: {failures}')


def spread_over(arr, n):
    """Number of distinct devices holding shards of ``arr``; asserts it
    is ``n``."""
    devs = {s.device for s in arr.addressable_shards}
    if len(devs) != n:
        raise AssertionError(f'array {arr.shape} lives on {len(devs)} '
                             f'device(s), expected {n}')
    return len(devs)


def collective_ops(runner, steps=5):
    """Names of collective-permute ops in a short device trace of the
    runner's loop, and the count in its compiled HLO."""
    hlo = runner._run_steps.lower(runner.f, steps, 0).compile().as_text()
    n_hlo = hlo.count('collective-permute-start(') + \
        hlo.count('collective-permute(')
    names = set()
    with tempfile.TemporaryDirectory() as tmp:
        with jax.profiler.trace(tmp):
            runner.f = runner._run_steps(runner.f, steps, 0)
            jax.block_until_ready(runner.f)
        for root, _, files in os.walk(tmp):
            for fn in files:
                if not fn.endswith('.xplane.pb'):
                    continue
                prof = jax.profiler.ProfileData.from_file(
                    os.path.join(root, fn))
                for plane in prof.planes:
                    for line in plane.lines:
                        for ev in line.events:
                            if 'collective-permute' in ev.name or \
                                    'ppermute' in ev.name.lower():
                                names.add(ev.name)
    return n_hlo, sorted(names)


def phase_four(card, shape=(256, 256, 1024), steps=100, atol=1e-6):
    devices = jax.devices()
    if len(devices) < 4:
        raise SystemExit(f'chip_smoke --four: {len(devices)} device(s)')
    nx, ny, nz = shape
    results = {}
    for mesh in ('4', '2x2'):
        r, _ = run_ldc(nx, ny, nz, iters=steps, every=steps,
                       sample_from=0, mesh=mesh)
        spread_over(r.f, 4)
        for k, v in r.builder.dev.items():
            spread_over(v, 4)
        for _, _, m in r.builder.bc_masks_dev:
            spread_over(m, 4)
        rho, u = r._macro(r.f, r.sim.iteration)
        results[mesh] = (np.asarray(rho), np.asarray(u))
        n_hlo, names = collective_ops(r)
        if n_hlo == 0:
            raise AssertionError(f'mesh {mesh}: no collective-permute')
        peaks = [peak_bytes(d) for d in devices[:4]]
        print(f'(4) mesh {mesh}: state and node maps on 4 devices; '
              f'peak_bytes_in_use per device {peaks}; '
              f'{n_hlo} collective-permutes in the HLO, trace ops '
              f'{names[:8]} [{card}]', flush=True)
        del r
    r, _ = run_ldc(nx, ny, nz, iters=steps, every=steps, sample_from=0)
    wet = r.builder.wet_np
    rho, u = (np.asarray(a) for a in r._macro(r.f, r.sim.iteration))
    for mesh, (rho_m, u_m) in results.items():
        err = max(float(np.abs(rho_m - rho)[wet].max()),
                  float(np.abs(u_m - u)[:, wet].max()))
        print(f'(4) mesh {mesh} vs one card, LDC {nx}x{ny}x{nz}, {steps} '
              f'steps: max |diff| of rho, u on wet nodes {err:.3e} '
              f'(atol {atol}) [{card}]', flush=True)
        if not err <= atol:
            raise AssertionError(f'mesh {mesh} differs: {err:.3e}')


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--four', action='store_true',
                   help='run only the four-card mesh path')
    args = p.parse_args(argv)
    # the goldens were written with hash randomization off
    if os.environ.get('PYTHONHASHSEED') != '0':
        os.environ['PYTHONHASHSEED'] = '0'
        os.execv(sys.executable, [sys.executable] + sys.argv)
    util.enable_compile_cache()
    cards = util.gpu_cards()
    for ln in cards:
        print(ln)
    devices = jax.devices()
    print('(a) jax devices:', devices, flush=True)
    util.require_gpu(devices)
    card = cards[0]
    clock = CompileClock()
    t0 = time.perf_counter()
    if args.four:
        phase_four(card)
    else:
        for phase in (lambda: phase_ldc_256(card, clock),
                      lambda: phase_ldc_512(card),
                      lambda: phase_reference(card),
                      lambda: phase_goldens(card),
                      lambda: phase_fused(card)):
            phase()
            gc.collect()
            print(f'    elapsed {time.perf_counter() - t0:.1f} s',
                  flush=True)
    print(result_line(jax.devices() if not args.four
                      else jax.devices()[:4]))
    return 0


if __name__ == '__main__':
    sys.exit(main())
