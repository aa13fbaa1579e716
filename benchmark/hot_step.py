#!/usr/bin/env python
"""What XLA makes of the plain D3Q19 step on one GPU, against the fused
Pallas (Triton) kernel of the same step (``ops/fused_bgk.py``).

Scene: D3Q19 BGK periodic box with a seeded 10% random solid field
(``chip_smoke.SolidBox``), so only fluid and full bounce-back nodes occur.
Variants: the XLA step and the fused kernel one step at a time, each in
a jitted ``fori_loop`` like the runner's, and the fused kernel's own
ping-pong loop (``fused_bgk.fused_loop``, what the runner uses).
Reported per variant: MLUPS from repeats in turns (host clock around
``block_until_ready``), device time per step and kernels per step from
a profiler trace, and for XLA the bytes per node that ``cost_analysis``
counts for one step (the floor is 152 B/node: 19 fp32 reads and writes).

    python benchmark/hot_step.py [--n 256] [--steps 200]
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from sailfish_tpu import util  # noqa: E402
from sailfish_tpu.ops import fused_bgk  # noqa: E402


def fused_step_loop(runner):
    """The fused kernel one step at a time in a fori_loop (a full-state
    copy into the loop carry per step)."""
    step = fused_bgk.fused_step(runner.builder)

    @jax.jit
    def run(f, n):
        return jax.lax.fori_loop(0, n, lambda i, a: step(a, i), f)
    return run


def timed(fn, f, steps, repeats=3):
    """MLUPS of ``repeats`` runs of ``steps`` steps each."""
    nodes = int(np.prod(f.shape[1:]))
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        f = fn(f, steps)
        jax.block_until_ready(f)
        out.append(nodes * steps / (time.perf_counter() - t0) / 1e6)
    return f, out


def trace_step(fn, f, steps):
    """(device seconds per step, kernels per step, busiest line name)
    from a profiler trace of ``steps`` steps."""
    with tempfile.TemporaryDirectory() as tmp:
        with jax.profiler.trace(tmp):
            f = fn(f, steps)
            jax.block_until_ready(f)
        best = None
        for root, _, files in os.walk(tmp):
            for fn_ in files:
                if not fn_.endswith('.xplane.pb'):
                    continue
                prof = jax.profiler.ProfileData.from_file(
                    os.path.join(root, fn_))
                for plane in prof.planes:
                    if 'GPU' not in plane.name:
                        continue
                    for line in plane.lines:
                        evs = list(line.events)
                        if not evs:
                            continue
                        dur = sum(e.duration_ns for e in evs)
                        by_name = {}
                        for e in evs:
                            by_name[e.name] = by_name.get(e.name, 0.0) \
                                + e.duration_ns
                        top = sorted(by_name.items(), key=lambda kv: -kv[1])
                        print(f'    trace {plane.name} / {line.name}: '
                              f'{len(evs)} events, {dur / 1e6:.3f} ms; top '
                              + ', '.join(f'{k} {v / 1e6:.2f} ms'
                                          for k, v in top[:6]))
                        if 'Stream' in line.name and (
                                best is None or len(evs) > best[1]):
                            best = (dur, len(evs), line.name)
    if best is None:
        return f, None
    return f, (best[0] / 1e9 / steps, best[1] / steps, best[2])


def xla_bytes_per_node(runner):
    """(bytes per node that cost_analysis counts for one XLA step, fusions
    in the compiled step's entry computation)."""
    f = runner.f
    comp = jax.jit(runner.builder.build()).lower(f, 0).compile()
    ca = comp.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    nodes = int(np.prod(f.shape[1:]))
    hlo = comp.as_text()
    entry = hlo[hlo.index('ENTRY'):]
    fusions = entry.count(' fusion(') + entry.count('=fusion(')
    return float(ca.get('bytes accessed', float('nan'))) / nodes, fusions


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--n', type=int, default=256)
    p.add_argument('--steps', type=int, default=200)
    args = p.parse_args()
    card = util.gpu_cards()[0]
    util.require_gpu(jax.devices())
    runner = chip_smoke.solid_box_runner(args.n)
    f0 = np.asarray(runner.f)
    bpn, fusions = xla_bytes_per_node(runner)
    print(f'XLA step: cost_analysis {bpn:.1f} bytes/node (floor 152), '
          f'{fusions} fusions in the entry computation [{card}]')
    variants = {'xla': chip_smoke.xla_loop(runner.builder),
                'fused step': fused_step_loop(runner),
                'fused loop': jax.jit(
                    fused_bgk.fused_loop(runner.builder))}
    # correctness: 20 steps from the same state
    outs = {}
    for name, fn in variants.items():
        outs[name] = np.asarray(fn(jnp.asarray(f0), 20))
    for name, out in outs.items():
        print(f'{name}: max |diff| vs xla after 20 steps '
              f'{np.abs(out - outs["xla"]).max():.3e} [{card}]')
    # timing in turns: A B.. B.. A
    order = list(variants) + list(reversed(variants))
    results = {k: [] for k in variants}
    for name in order:
        f = jnp.asarray(f0)
        f = variants[name](f, 10)
        jax.block_until_ready(f)
        f, mlups = timed(variants[name], f, args.steps)
        results[name] += mlups
    for name, vals in results.items():
        print(f'{name}: MLUPS {sorted(vals)} median '
              f'{float(np.median(vals)):.1f} '
              f'(D3Q19 {args.n}^3, {args.steps} steps/repeat) [{card}]')
    for name, fn in variants.items():
        f = jnp.asarray(f0)
        _, tr = trace_step(fn, f, 20)
        if tr is not None:
            sec, kern, line = tr
            print(f'{name}: device {sec * 1e3:.4f} ms/step, '
                  f'{kern:.1f} kernels/step ({line}), '
                  f'{152 * args.n ** 3 / sec / 1e12:.3f} TB/s at the '
                  f'152 B/node floor [{card}]')
    return 0


if __name__ == '__main__':
    sys.exit(main())
