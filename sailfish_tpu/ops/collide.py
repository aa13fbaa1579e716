"""Collision operators as traced JAX functions.

Counterpart of the reference's generated relaxation kernels
(``templates/relaxation.mako:99-181`` BGK, ``relaxation_mrt.mako`` MRT,
``relaxation_common.mako:153`` Smagorinsky, ``:56-108`` Guo/EDM forces).

All operators map (f, rho, u, ...) -> post-collision f on the full field;
the caller masks out non-colliding (dry/excluded) nodes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from sailfish_tpu import equilibrium as eq


def bgk_collide(grid, f, rho, u, tau_inv, *, incompressible=False):
    """f + (feq - f)/tau. tau_inv may be a scalar or a per-node field
    (LES). Reference: relaxation.mako:99-181."""
    feq = eq.bgk_equilibrium(grid, rho, u, incompressible=incompressible)
    return f + tau_inv * (feq - f)


def mrt_collide(grid, f, rho, u, rates, *, incompressible=False):
    """Multiple-relaxation-time collision in moment space.

    m = M f; m += s (m_eq - m); f' = M^-1 m, with m_eq = M feq so that the
    operator reduces exactly to BGK when all rates are equal
    (reference: relaxation_mrt.mako; matrices from sym.py:86-226).
    rates: (Q,) numpy vector from Grid.mrt_relaxation_rates.
    """
    dtype = f.dtype
    feq = eq.bgk_equilibrium(grid, rho, u, incompressible=incompressible)
    # Fold the diagonal relaxation into a single Q x Q matrix:
    # f' = f + Minv diag(s) M (feq - f) = f + R (feq - f).
    R = (grid.mrt_inv @ np.diag(np.asarray(rates)) @ grid.mrt_matrix)
    Rj = jnp.asarray(R, dtype=dtype)
    dneq = (feq - f).reshape(grid.Q, -1)
    upd = jnp.einsum('qp,pn->qn', Rj, dneq,
                     precision=jax.lax.Precision.HIGHEST
                     if dtype == jnp.float32 else None)
    return f + upd.reshape(f.shape)


def smagorinsky_tau_inv(grid, f, feq, rho, tau, cs_smag):
    """Effective 1/tau field with the Smagorinsky subgrid model.

    Follows Yu, Girimaji & Luo, JCP 209 (2005) 599-616 as implemented by
    the reference (relaxation_common.mako:166-203, --subgrid
    les-smagorinsky):
      strain = sum_ab T_ab^2   (T = nonequilibrium stress; off-diagonal
                                terms counted twice by symmetry)
      tau_eff = tau + 0.5 (sqrt(tau^2 + 36 C^2 sqrt(strain)) - tau)
    """
    pi = eq.second_moment_noneq(grid, f, feq)
    strain = jnp.sum(pi * pi, axis=(0, 1))  # symmetric: off-diag twice
    tau_t = 0.5 * (jnp.sqrt(tau * tau + 36.0 * (cs_smag ** 2)
                            * jnp.sqrt(strain)) - tau)
    return 1.0 / (tau + tau_t)


def guo_force_terms(grid, u, accel, tau_inv, rho=None):
    """Guo (2002) forcing population increment.

    S_i = w_i (1 - 1/(2 tau)) rho [ 3 (c_i - u) + 9 (c_i . u) c_i ] . a
    with ``accel`` an ACCELERATION (the reference's body-force values are
    accelerations; its generated code includes the density factor --
    sym_force.py:150-161 "the device code always computes accelerations").
    accel: (dim, *S) or broadcastable. Returns (Q, *S) post-collision
    increment.
    """
    dtype = u.dtype
    w = grid.weights
    cu = eq.dot_cu(grid, u)                    # (Q, *S)
    cF = eq.dot_cu(grid, accel)                # (Q, *S) via same +/- sums
    uF = jnp.sum(u * accel, axis=0)            # (*S)
    shape = (grid.Q,) + (1,) * (cu.ndim - 1)
    wq = jnp.asarray(w, dtype=dtype).reshape(shape)
    pref = 1.0 - 0.5 * tau_inv
    out = pref * wq * (3.0 * (cF - uF[None]) + 9.0 * cu * cF)
    if rho is not None:
        out = out * rho[None]
    return out


SHAN_CHEN_POTENTIALS = {
    'linear': lambda rho: rho,
    'classic': lambda rho: 1.0 - jnp.exp(-rho),
}


def shan_chen_force(grid, rho_self, rho_other, coupling, potential='linear'):
    """Pseudopotential interaction force
    F(x) = -G psi(rho_self(x)) sum_i w_i psi(rho_other(x + c_i)) c_i
    (reference templates/shan_chen.mako:9-84, sym.py:896-908).
    Returns (dim, *S)."""
    from sailfish_tpu.ops.step import sample
    psi_fn = SHAN_CHEN_POTENTIALS[potential]
    psi_other = psi_fn(rho_other)
    acc = [jnp.zeros_like(rho_self) for _ in range(grid.dim)]
    for i in range(1, grid.Q):
        psi_n = sample(psi_other, grid.basis[i])
        w = float(grid.weights[i])
        for a in range(grid.dim):
            c = int(grid.basis[i][a])
            if c:
                acc[a] = acc[a] + (w * c) * psi_n
    psi_self = psi_fn(rho_self)
    return jnp.stack([-coupling * psi_self * a for a in acc])


def edm_shift(grid, rho, u, accel, *, incompressible=False):
    """Exact-difference-method forcing: feq(rho, u + a) - feq(rho, u)
    (Kupershtokh; reference sym_force.edm_shift_velocity, sym_force.py:184
    -- the shift is the acceleration).
    """
    du = accel + 0.0 * rho[None]
    return (eq.bgk_equilibrium(grid, rho, u + du,
                               incompressible=incompressible)
            - eq.bgk_equilibrium(grid, rho, u, incompressible=incompressible))
