"""Entropic LBM (ELBM): product-form equilibrium + entropy-equality alpha.

Counterpart of the reference's generated entropic code
(``templates/entropic.mako``: ComputeACoeff/EstimateAlphaSeries :9-45,
CalculateEntropy :48-58, Newton solver EstimateAlphaFromEntropy :90-144,
dispatch EntropicRelaxationParam :160-184) and the product-form
equilibrium (``sym_equilibrium.elbm_equilibrium``, sym_equilibrium.py:123).

The per-node scalar Newton iteration becomes a fixed-count vectorized
loop with convergence masking -- data-independent control flow that XLA
and Pallas both like. All Q-reductions are unrolled sequential adds
with SCALAR per-direction constants: the same trace then serves the XLA
engine and the fused Pallas kernels (which reject captured constant
vectors), keeping the two engines fp32-identical.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np


def elbm_equilibrium(grid, rho, u):
    """Product-form entropic equilibrium (Ansumali & Karlin, EPL 63 (2003)
    798; reference sym_equilibrium.py:123-155):

      feq_i = rho w_i prod_a (2 - sqrt(1+3 u_a^2)) B_a^{c_ia},
      B_a = (2 u_a + sqrt(1 + 3 u_a^2)) / (1 - u_a)
    """
    dtype = rho.dtype
    pref = rho
    Bs = []
    for a in range(grid.dim):
        ua = u[a]
        s = jnp.sqrt(1.0 + 3.0 * ua * ua)
        pref = pref * (2.0 - s)
        Bs.append((2.0 * ua + s) / (1.0 - ua))
    out = []
    for i in range(grid.Q):
        t = pref * jnp.asarray(grid.weights[i], dtype)
        for a in range(grid.dim):
            c = int(grid.basis[i][a])
            if c == 1:
                t = t * Bs[a]
            elif c == -1:
                t = t / Bs[a]
        out.append(t)
    return jnp.stack(out)


def _entropy(grid, f):
    """H(f) = sum_i f_i (ln f_i - ln w_i) (entropic.mako:48-58)."""
    acc = None
    for i in range(grid.Q):
        logw = math.log(float(grid.weights[i]))
        t = f[i] * (jnp.log(f[i]) - jnp.asarray(logw, f.dtype))
        acc = t if acc is None else acc + t
    return acc


def alpha_series(grid, f, fneq):
    """Asymptotic expansion of the entropy equality in powers of fneq/f
    (PRL 97, 010201 (2006) Eq. 12; reference entropic.mako:9-45 and
    sym.alpha_series, sym.py:431-447)."""
    a1 = a2 = a3 = a4 = None
    for i in range(grid.Q):
        inv = 1.0 / f[i]
        t = fneq[i] * inv
        p = fneq[i] * t       # fneq^2 / f
        a1 = p if a1 is None else a1 + p
        p = p * t
        a2 = p if a2 is None else a2 + p
        p = p * t
        a3 = p if a3 is None else a3 + p
        p = p * t
        a4 = p if a4 is None else a4 + p
    a1 = a1 * 0.5
    a2 = a2 * (-1.0 / 6.0)
    a3 = a3 * (1.0 / 12.0)
    a4 = a4 * (-1.0 / 20.0)
    ia1 = 1.0 / a1
    return (2.0
            - 4.0 * a2 * ia1
            + 16.0 * a2 * a2 * ia1 * ia1
            - 8.0 * a3 * ia1
            + 80.0 * a2 * a3 * ia1 * ia1
            - 80.0 * a2 ** 3 * ia1 ** 3
            - 16.0 * a4 * ia1)


def alpha_newton(grid, f, fneq, alpha0, iters=20, entropy_tol=1e-6,
                 skip=None, alpha_tol=1e-10):
    """Vectorized Newton iteration on H(f + alpha fneq) = H(f)
    (entropic.mako:90-144), with the max-alpha positivity safeguard.

    ``skip``: lanes whose result the caller will discard (they take
    the tiny-deviation or series branch of the dispatch); marking
    them pre-converged keeps them from holding the loop open -- in a
    resolved flow most lanes are below the series threshold, so the
    all-lanes-converged early exit then fires after the one or two
    iterations the genuinely supersonic lanes need. When EVERY lane is
    skipped (the common case: a whole block below the series
    threshold) the entropy/positivity prologue and the loop are
    bypassed entirely."""
    if skip is not None:
        # branch around the whole solve when every node is skipped
        # rather than enter a zero-iteration while_loop
        return jax.lax.cond(
            jnp.all(skip), lambda: alpha0,
            lambda: _alpha_newton_loop(grid, f, fneq, alpha0, iters,
                                       entropy_tol, skip, alpha_tol))
    return _alpha_newton_loop(grid, f, fneq, alpha0, iters,
                              entropy_tol, skip, alpha_tol)


def _alpha_newton_loop(grid, f, fneq, alpha0, iters, entropy_tol,
                       skip, alpha_tol=1e-10):
    ent0 = _entropy(grid, f)
    # max alpha keeping f + alpha fneq > 0
    big = jnp.asarray(np.float32(3.4e38), f.dtype)
    max_alpha = None
    for i in range(grid.Q):
        r = jnp.where(fneq[i] < 0.0, -f[i] / fneq[i], big)
        max_alpha = r if max_alpha is None else jnp.minimum(max_alpha, r)

    def step(alpha):
        ent = None
        dent = None
        for i in range(grid.Q):
            t = jnp.maximum(f[i] + alpha * fneq[i], 1e-12)
            logw = math.log(float(grid.weights[i]))
            h = jnp.log(t) - jnp.asarray(logw, f.dtype)
            e = t * h
            d = fneq[i] * (h + 1.0)
            ent = e if ent is None else ent + e
            dent = d if dent is None else dent + d
        inc = ent - ent0
        new_alpha = alpha - inc / dent
        new_alpha = jnp.where(new_alpha > max_alpha,
                              0.5 * (alpha + max_alpha), new_alpha)
        new_alpha = jnp.where(jnp.isfinite(new_alpha), new_alpha, 1.1)
        # two stops, exactly as the reference (entropic.mako:105,117):
        # the entropy residual (--entropy_tolerance) and alpha
        # stagnation (--alpha_tolerance)
        done = (jnp.abs(inc) < entropy_tol) \
            | (jnp.abs(new_alpha - alpha) < alpha_tol)
        if skip is not None:
            done = done | skip
        return jnp.where(done, alpha, new_alpha), done

    # early exit once EVERY lane converged: iterating a converged lane
    # is the identity (the done-freeze above), so this returns
    # bit-identical alphas to a fixed `iters`-deep loop while typically
    # stopping after 3-6 Newton steps -- the 20x Q logs per iteration
    # are the entire ELBM compute bill
    def cond(state):
        i, _, all_done = state
        return (i < iters) & jnp.logical_not(all_done)

    def body(state):
        i, alpha, _ = state
        new_alpha, done = step(alpha)
        return i + 1, new_alpha, jnp.all(done)

    # all-skipped blocks (the common case away from boundaries) enter
    # with all_done already true: the loop body runs ZERO times
    done0 = jnp.all(skip) if skip is not None else jnp.bool_(False)
    _, alpha, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), alpha0, done0))
    return alpha


def entropic_alpha(grid, f, fneq, alpha0=None, skip=None,
                   entropy_tol=1e-6, alpha_tol=1e-10):
    """Dispatch exactly as the reference (entropic.mako:160-184):
    tiny deviation -> 2; small -> series; large -> Newton.

    ``skip``: lanes whose collision result the caller discards (wall /
    keep / BC-overlaid nodes). The reference's per-node kernels never
    even run the entropic collision there; the vectorized loop must at
    least keep such lanes from holding every other lane's Newton open
    (an LDC lid corner 2-cycles against the positivity bound forever,
    forcing the full iteration cap on the whole domain)."""
    dev = None
    for i in range(grid.Q):
        d = jnp.abs(fneq[i]) / jnp.maximum(f[i], 1e-12)
        dev = d if dev is None else jnp.maximum(dev, d)
    a_series = alpha_series(grid, f, fneq)
    if alpha0 is None:
        # Newton seed: the series estimate where sane -- one to two
        # iterations to the entropy tolerance vs four to six from a
        # cold 2.0 (the 20x Q logs per iteration are the whole ELBM
        # compute bill)
        alpha0 = jnp.where(
            jnp.isfinite(a_series) & (a_series > 1.0) & (a_series < 4.0),
            a_series, jnp.asarray(2.0, f[0].dtype))
    # lanes below the series threshold take the series/tiny branch of
    # the dispatch below; don't let them hold the Newton loop open
    newton_skip = dev < 0.01
    if skip is not None:
        newton_skip = newton_skip | skip
    a_newton = alpha_newton(grid, f, fneq, alpha0, skip=newton_skip,
                            entropy_tol=entropy_tol,
                            alpha_tol=alpha_tol)
    alpha = jnp.where(dev < 1e-6, 2.0,
                      jnp.where(dev < 0.01, a_series, a_newton))
    # safeguard (reference dies here; we clamp to BGK-equivalent)
    alpha = jnp.where(jnp.isfinite(alpha) & (alpha >= 1.0), alpha, 2.0)
    return alpha


def elbm_collide(grid, f, rho, u, tau, alpha0=None, skip=None,
                 entropy_tol=1e-6, alpha_tol=1e-10):
    """ELBM collision: f' = f + alpha beta (feq - f), beta = 1/(2 tau);
    alpha == 2 recovers BGK (reference relaxation.mako ELBM_relaxate
    :56-97). ``skip``: see entropic_alpha; ``entropy_tol``/
    ``alpha_tol``: the Newton stops (--entropy_tolerance /
    --alpha_tolerance, reference lb_single.py:43-50). Returns
    (f', alpha)."""
    feq = elbm_equilibrium(grid, rho, u)
    fneq = feq - f
    alpha = entropic_alpha(grid, f, fneq, alpha0, skip=skip,
                           entropy_tol=entropy_tol,
                           alpha_tol=alpha_tol)
    beta = 1.0 / (2.0 * tau)
    return f + (alpha * beta)[None] * fneq, alpha
