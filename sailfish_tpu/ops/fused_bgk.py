"""Fused D3Q19 BGK step for NVIDIA GPUs: one Pallas kernel through Triton.

One program per block of consecutive nodes (x fastest): pull streaming
with periodic wrap as gathers from the source buffer, BGK collision in
registers, full bounce-back at solid nodes, and one write per
distribution -- the reference's one-thread-per-node CollideAndPropagate
kernel. XLA's fusion of ``StepBuilder``'s step materializes intermediate
(Q, N) arrays and moves far more than the 152 bytes per node this kernel
reads and writes (PERF.md, "Findings").

The kernel covers exactly the scenes that need nothing more: D3Q19, BGK
collision with the compressible equilibrium, no body force, subgrid model
or Shan-Chen coupling, fp32 storage, fluid and full bounce-back nodes
only, one device. ``unsupported`` names what keeps a scene off it; such
scenes run ``StepBuilder.build()``, which is also this kernel's semantics
reference (tests/test_fused_bgk.py compares them in interpret mode).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from sailfish_tpu import node_type as nt

#: nodes and warps per program (one H100 SXM at 700 W: 256 nodes with 4
#: warps, 512 with 4 and 1024 with 8 ran within 0.5% of each other)
BLOCK = 256
NUM_WARPS = 4

_NODE_TYPES = {nt._NTFluid.id, nt.NTFullBBWall.id}


def unsupported(builder, mesh=None):
    """Reasons the fused kernel cannot run ``builder``'s scene; empty when
    it can."""
    from sailfish_tpu.ops.step import StepBuilder
    if type(builder) is not StepBuilder:
        return [f'{type(builder).__name__} scenes']
    reasons = []
    checks = (
        (builder.grid.name != 'D3Q19', f'grid {builder.grid.name}'),
        (builder.model != 'bgk', f'model {builder.model}'),
        (builder.equilibrium != 'bgk',
         f'equilibrium {builder.equilibrium}'),
        (builder.incompressible, 'incompressible equilibrium'),
        (builder.smagorinsky > 0.0, 'subgrid model'),
        (builder.body_force is not None, 'body force'),
        (builder.sc_coupling != 0.0, 'Shan-Chen coupling'),
        (builder.mixed is not None, 'int16 storage'),
        (builder.dtype != jnp.float32, 'not fp32'),
        (mesh is not None, 'device mesh'),
        (builder.grid.Q * builder.maps.type_map.size >= 2 ** 31,
         'state of 2**31 or more values (int32 offsets)'),
    )
    reasons += [why for bad, why in checks if bad]
    other = set(builder.present) - _NODE_TYPES
    if other:
        reasons.append('node types ' + ', '.join(
            sorted(nt.get_node_type(t).__name__ for t in other)))
    return reasons


def _kernel_call(builder, interpret, aliased):
    """One step of the (Q, N) state. ``aliased``: call(src, dst, solid)
    -> dst, written into ``dst``'s buffer (``src`` and ``dst`` must be
    distinct buffers, since programs read neighbours of the nodes others
    write); otherwise call(src, solid) -> a fresh buffer."""
    reasons = unsupported(builder)
    if reasons:
        raise ValueError('fused BGK kernel: ' + '; '.join(reasons))
    g = builder.grid
    Z, Y, X = builder.maps.type_map.shape
    N = Z * Y * X
    basis = [tuple(int(v) for v in c) for c in g.basis]
    weights = [float(w) for w in g.weights]
    opp = [int(o) for o in g.opposite]
    omega = float(builder.tau_inv)

    def kernel(f_ref, solid_ref, o_ref):
        start = pl.program_id(0) * BLOCK
        n = start + jax.lax.iota(jnp.int32, BLOCK)
        inside = n < N
        x = n % X
        y = (n // X) % Y
        z = (n // (X * Y)) % Z   # wraps the tail block's lanes past N
        fs = [f_ref[i, (((z - cz) % Z) * Y + (y - cy) % Y) * X
                    + (x - cx) % X]
              for i, (cx, cy, cz) in enumerate(basis)]
        wall = solid_ref[(z * Y + y) * X + x] != 0
        rho = fs[0]
        for v in fs[1:]:
            rho = rho + v
        inv = 1.0 / rho
        u = []
        for a in range(3):
            mom = None
            for i, c in enumerate(basis):
                if c[a]:
                    t = fs[i] if c[a] > 0 else -fs[i]
                    mom = t if mom is None else mom + t
            u.append(mom * inv)
        usq = u[0] * u[0] + u[1] * u[1] + u[2] * u[2]
        for i, c in enumerate(basis):
            cu = None
            for a in range(3):
                if c[a]:
                    t = u[a] if c[a] > 0 else -u[a]
                    cu = t if cu is None else cu + t
            poly = 1.0 - 1.5 * usq
            if cu is not None:
                poly = poly + 3.0 * cu + 4.5 * cu * cu
            feq = weights[i] * rho * poly
            post = fs[i] + omega * (feq - fs[i])
            pltriton.store(o_ref.at[i, pl.ds(start, BLOCK)],
                           jnp.where(wall, fs[opp[i]], post), mask=inside)

    def kernel_into(f_ref, dst_ref, solid_ref, o_ref):
        del dst_ref   # the same buffer as o_ref
        kernel(f_ref, solid_ref, o_ref)

    return pl.pallas_call(
        kernel_into if aliased else kernel,
        out_shape=jax.ShapeDtypeStruct((g.Q, N), jnp.float32),
        grid=(pl.cdiv(N, BLOCK),), interpret=interpret,
        input_output_aliases={1: 0} if aliased else {},
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        name='fused_bgk_d3q19')


def _solid(builder):
    return jnp.asarray((builder.maps.type_map == nt.NTFullBBWall.id)
                       .reshape(-1).astype(np.int8))


def fused_step(builder, interpret=False):
    """step(f, it=0) -> f for ``builder``'s scene (see ``unsupported``);
    ``f`` has shape (19, Z, Y, X). ``interpret`` runs the kernel in the
    Pallas interpreter (CPU tests). Each call writes a fresh buffer,
    which a loop carrying the state copies back into its own:
    ``fused_loop`` avoids that copy."""
    call = _kernel_call(builder, interpret, False)
    solid = _solid(builder)

    def step(f, it=0):
        return call(f.reshape(f.shape[0], -1), solid).reshape(f.shape)

    return step


def fused_loop(builder, interpret=False):
    """run(f, n, it0=0) -> f after n steps, two per loop iteration
    ping-ponging between the state and one scratch buffer, so that every
    step writes in place of a loop-carried buffer and no step pays a
    full-state copy."""
    call = _kernel_call(builder, interpret, True)
    solid = _solid(builder)

    def run(f, n, it0=0):
        a = f.reshape(f.shape[0], -1)

        def two(i, ab):
            a, b = ab
            b = call(a, b, solid)
            return call(b, a, solid), b

        a, b = jax.lax.fori_loop(0, n // 2, two, (a, jnp.empty_like(a)))
        a = jax.lax.cond(n % 2 == 1, lambda a, b: call(a, b, solid),
                         lambda a, b: a, a, b)
        return a.reshape(f.shape)

    return run
