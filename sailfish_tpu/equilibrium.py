"""Equilibrium distributions and macroscopic moments as traced JAX functions.

Counterpart of the reference's sympy expression builders
(``sailfish/sym_equilibrium.py:90`` bgk_equilibrium, ``sailfish/sym.py:573,629``
ex_rho/ex_velocity). Everything here is shape-polymorphic vectorized jnp math:
distributions have shape (Q, *spatial), macroscopic fields (*spatial) or
(dim, *spatial).

Because all basis-vector components are in {-1, 0, 1}, the Q-axis
contractions are emitted as unrolled adds/subtracts rather than matmuls:
exact in fp32 (no reduced-precision matrix unit pass), and XLA fuses them
into the surrounding elementwise work.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def signed_sum(coeffs, terms):
    """sum_i coeffs[i] * terms[i] with coeffs a python/numpy sequence of
    small integers; emitted as unrolled +/- adds (exact, fusable)."""
    acc = None
    for w, t in zip(coeffs, terms):
        w = int(w)
        if w == 0:
            continue
        term = t if w == 1 else (-t if w == -1 else w * t)
        acc = term if acc is None else acc + term
    if acc is None:
        acc = jnp.zeros_like(terms[0])
    return acc


def macroscopic(grid, f):
    """rho, u from distributions. f: (Q, *S) -> rho (*S), u (dim, *S).

    Counterpart of ex_rho / ex_velocity (sailfish/sym.py:573,629).
    """
    rho = jnp.sum(f, axis=0)
    mom = momentum(grid, f)
    u = mom / rho[None]
    return rho, u


def density(grid, f):
    return jnp.sum(f, axis=0)


def momentum(grid, f):
    """(dim, *S) momentum: mom_a = sum_i c_ia f_i (unrolled adds)."""
    fs = [f[i] for i in range(grid.Q)]
    return jnp.stack([signed_sum(grid.basis[:, a], fs)
                      for a in range(grid.dim)])


def dot_cu(grid, u):
    """(Q, *S) array of c_i . u, via unrolled +/- of velocity components."""
    us = [u[a] for a in range(grid.dim)]
    return jnp.stack([signed_sum(grid.basis[i], us) for i in range(grid.Q)])


def bgk_equilibrium(grid, rho, u, *, incompressible=False, order=2):
    """Second-order Hermite (standard LBM) equilibrium.

    f_eq_i = w_i [ rho + rho_m (3 c.u + 4.5 (c.u)^2 - 1.5 u.u) ]
    where rho_m = rho for the compressible model and rho_m = rho0 = 1 for the
    incompressible model (reference: sym_equilibrium.bgk_equilibrium,
    sailfish/sym_equilibrium.py:90-121, incl. the rho0 split at :97-106).

    rho: (*S), u: (dim, *S) -> (Q, *S)
    """
    dtype = rho.dtype
    w = grid.weights.astype(np.float64)
    cu = dot_cu(grid, u)                       # (Q, *S)
    usq = jnp.sum(u * u, axis=0)               # (*S)
    shape = (grid.Q,) + (1,) * rho.ndim
    wq = jnp.asarray(w, dtype=dtype).reshape(shape)
    poly = 3.0 * cu
    if order >= 2:
        poly = poly + 4.5 * cu * cu - 1.5 * usq[None]
    rho_m_poly = poly if incompressible else rho[None] * poly
    return wq * (rho[None] + rho_m_poly)


def shallow_water_equilibrium(grid, rho, u, gravity):
    """Shallow-water-equation equilibrium on D2Q9 (rho plays the role of
    the water height h; reference sym_equilibrium.py:73-89):
      f0  = h - w0 h (15/8 g h - 3 u.u)
      fi  = w_i h (3/2 g h + 3 c.u + 9/2 (c.u)^2 - 3/2 u.u)
    """
    assert grid.dim == 2 and grid.Q == 9, \
        'shallow water equation requires the D2Q9 grid'
    dtype = rho.dtype
    cu = dot_cu(grid, u)
    usq = jnp.sum(u * u, axis=0)
    out = [rho - grid.weights[0] * rho * (
        (15.0 / 8.0) * gravity * rho - 3.0 * usq)]
    for i in range(1, grid.Q):
        out.append(jnp.asarray(grid.weights[i], dtype) * rho * (
            1.5 * gravity * rho + 3.0 * cu[i] + 4.5 * cu[i] * cu[i]
            - 1.5 * usq))
    return jnp.stack(out)


def second_moment_noneq(grid, f, feq):
    """Nonequilibrium second moment Pi^{(1)}_{ab} = sum_i c_ia c_ib (f_i-feq_i).

    Used by the regularized BCs/model (reference: sym.py:850-894).
    Returns (dim, dim, *S).
    """
    fneq = f - feq
    fs = [fneq[i] for i in range(grid.Q)]
    c = grid.basis
    rows = []
    for a in range(grid.dim):
        row = [signed_sum(c[:, a] * c[:, b], fs) for b in range(grid.dim)]
        rows.append(jnp.stack(row))
    return jnp.stack(rows)


def regularized_f(grid, rho, u, pi_neq, *, incompressible=False):
    """Regularized distribution: feq + w_i/(2 cs^4) Q_i : Pi^(1)
    with Q_i = c_i c_i - cs^2 I (Latt & Chopard regularized LB; reference
    --regularized option and NTRegularized* BCs, sym.py:850-894)."""
    dtype = rho.dtype
    cs2 = grid.cs2
    feq = bgk_equilibrium(grid, rho, u, incompressible=incompressible)
    c = grid.basis.astype(np.float64)
    # Q_i : Pi = sum_ab (c_ia c_ib - cs2 d_ab) Pi_ab, unrolled over (a, b).
    qpi_terms = []
    for i in range(grid.Q):
        acc = None
        for a in range(grid.dim):
            for b in range(grid.dim):
                coef = c[i, a] * c[i, b] - (cs2 if a == b else 0.0)
                if abs(coef) < 1e-14:
                    continue
                t = coef * pi_neq[a, b]
                acc = t if acc is None else acc + t
        if acc is None:
            acc = jnp.zeros_like(rho)
        qpi_terms.append(acc)
    qpi = jnp.stack(qpi_terms)
    shape = (grid.Q,) + (1,) * rho.ndim
    wq = jnp.asarray(grid.weights, dtype=dtype).reshape(shape)
    return feq + wq * qpi / (2.0 * cs2 * cs2)
