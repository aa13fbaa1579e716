"""Lattice (DxQy) definitions: basis vectors, weights, opposites, moment matrices.

Counterpart of the reference's symbolic grid layer
(``sailfish/sym.py:61-466`` defines D2Q9/D3Q13/D3Q15/D3Q19/D3Q27 with sympy).
Here every lattice is a set of precomputed numpy constant tables consumed
directly by traced JAX functions -- there is no runtime
code generation and no sympy in the hot path.

Conventions:
  * Basis vectors are integer numpy arrays of shape (Q, dim), ordered
    deterministically: rest vector first, then vectors sorted by
    (|c|^2, lexicographic). This ordering is stable across runs and is the
    on-disk checkpoint format.
  * ``opposite[i]`` is the index j with c_j == -c_i (bounce-back pairs,
    the analog of ``sym.bb_swap_pairs``, sailfish/sym.py:468).
  * Axis order of spatial fields is (z, y, x); basis vector components are
    stored (cx, cy, cz) to match the user-facing coordinate convention of
    the reference API (hx, hy, hz index arrays).
  * cs^2 = 1/3 for all shipped lattices.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np


def _sorted_vectors(vecs):
    """Deterministic ordering: rest first, then by (shell, lexicographic)."""
    return sorted(vecs, key=lambda v: (int(sum(c * c for c in v)), v))


def _opposites(basis):
    q = len(basis)
    idx = {tuple(v): i for i, v in enumerate(basis.tolist())}
    return np.array([idx[tuple(-c for c in v)] for v in basis.tolist()],
                    dtype=np.int32)


class Grid:
    """A single DxQy lattice: constant tables + moment (MRT) machinery.

    Attributes:
      name: 'D2Q9' etc.
      dim: 2 or 3.
      Q: number of discrete velocities.
      basis: (Q, dim) int array; columns are (cx, cy[, cz]).
      weights: (Q,) float64 quadrature weights.
      opposite: (Q,) int indices of the reversed vector.
      cs2: squared speed of sound (1/3).
      mrt_matrix: (Q, Q) moment transform M (orthogonalized) or None.
      mrt_inv: inverse of mrt_matrix.
      mrt_collision: per-moment metadata for building relaxation vectors.
    """

    def __init__(self, name, dim, basis, weights):
        self.name = name
        self.dim = dim
        self.basis = np.asarray(basis, dtype=np.int32)
        self.Q = len(self.basis)
        self.weights = np.asarray(weights, dtype=np.float64)
        assert abs(self.weights.sum() - 1.0) < 1e-12, name
        self.opposite = _opposites(self.basis)
        self.cs2 = 1.0 / 3.0
        self._build_moment_basis()

    # -- MRT ---------------------------------------------------------------

    def _moment_polynomials(self):
        """Raw (non-orthogonal) moment polynomial values per velocity.

        Rows follow the standard hydrodynamic ordering: density, momentum,
        energy, stress, then higher-order ghost moments completed by
        Gram-Schmidt over monomials. Functional counterpart of the per-grid
        MRT bases in sailfish/sym.py:86-226 (which hard-codes the published
        Lallemand-Luo / d'Humieres matrices); orthogonalizing monomial
        moments yields an equivalent moment space.
        """
        c = self.basis.astype(np.float64)
        cx = c[:, 0]
        cy = c[:, 1]
        cz = c[:, 2] if self.dim == 3 else np.zeros_like(cx)
        c2 = cx * cx + cy * cy + cz * cz

        rows = [np.ones(self.Q), cx, cy]
        if self.dim == 3:
            rows.append(cz)
        rows.append(c2)                       # energy
        rows.append(cx * cx - cy * cy)        # normal stress diff
        if self.dim == 3:
            rows.append(cy * cy - cz * cz)
        rows.append(cx * cy)                  # shear stresses
        if self.dim == 3:
            rows.append(cy * cz)
            rows.append(cx * cz)
        # Complete the basis with higher-order monomials.
        degrees = range(0, 5)
        for ex, ey, ez in itertools.product(degrees, repeat=3):
            if len(rows) == self.Q:
                break
            if self.dim == 2 and ez > 0:
                continue
            cand = (cx ** ex) * (cy ** ey) * (cz ** ez)
            test = np.vstack(rows + [cand])
            if np.linalg.matrix_rank(test) == len(rows) + 1:
                rows.append(cand)
        assert len(rows) == self.Q, (self.name, len(rows))
        return np.vstack(rows)

    def _build_moment_basis(self):
        raw = self._moment_polynomials()
        # Gram-Schmidt with the unweighted inner product <a,b> = sum_i a_i b_i
        # (the convention of the published MRT matrices).
        m = raw.copy()
        for i in range(self.Q):
            for j in range(i):
                denom = m[j] @ m[j]
                if denom > 1e-12:
                    m[i] = m[i] - (m[i] @ m[j]) / denom * m[j]
        # Clean tiny numerical noise; entries of the classic matrices are
        # rationals with small denominators.
        m[np.abs(m) < 1e-9] = 0.0
        self.mrt_matrix = m
        self.mrt_inv = np.linalg.inv(m)
        # Classify moments for relaxation-rate assignment. The raw moment
        # rows are emitted in a fixed order by _moment_polynomials, and
        # Gram-Schmidt only mixes a row with *earlier* rows, so index-based
        # classification is exact as long as same-class rows are grouped:
        #   2D: [rho, jx, jy, e, pxx-pyy, pxy, ghosts...]
        #   3D: [rho, jx, jy, jz, e, pxx-pyy, pyy-pzz, pxy, pyz, pxz, ...]
        # (the energy row precedes shear, so shear rows can pick up an
        # energy admixture; both families are non-conserved kinetic moments
        # and the viscosity is set purely by the shear relaxation rate).
        if self.dim == 2:
            conserved = [0, 1, 2]
            energy = [3]
            shear = [4, 5]
        else:
            conserved = [0, 1, 2, 3]
            energy = [4]
            shear = [5, 6, 7, 8, 9]
        self.mrt_conserved = np.array(conserved, dtype=np.int32)
        self.mrt_shear = np.array(shear, dtype=np.int32)
        self.mrt_energy = np.array(energy, dtype=np.int32)
        # Parity of each moment under c -> -c (+1 even, -1 odd). Lattices are
        # inversion-symmetric, so Gram-Schmidt preserves parity and every row
        # has a definite sign. Needed for stable (TRT-style) rate assignment.
        parity = np.zeros(self.Q, dtype=np.int32)
        for i in range(self.Q):
            row = self.mrt_matrix[i]
            if np.allclose(row[self.opposite], row):
                parity[i] = 1
            elif np.allclose(row[self.opposite], -row):
                parity[i] = -1
            else:
                raise AssertionError(f'{self.name}: moment {i} lacks parity')
        self.mrt_parity = parity

    @functools.cached_property
    def visc_tau_slope(self):
        """d(tau)/d(nu) for axis-aligned shear: 1 / (3 A) with
        A = sum_i w_i c_ix^2 c_iy^2. For 4th-order-isotropic lattices
        A = cs^4 = 1/9 and the slope is the familiar 3; D3Q13 has
        A = 1/6 (its known anisotropy; tests/test_lattice.py) giving
        nu = (tau - 1/2)/2, i.e. slope 2."""
        from fractions import Fraction
        A = sum(Fraction(w).limit_denominator(10 ** 6)
                * int(b[0]) ** 2 * int(b[1]) ** 2
                for w, b in zip(self.weights, self.basis))
        return float(1 / (3 * A))

    def relaxation_time(self, visc):
        """tau producing shear viscosity ``visc`` on THIS lattice
        (grid-aware generalization of sym.relaxation_time,
        sym.py:847)."""
        return visc * self.visc_tau_slope + 0.5

    def mrt_relaxation_rates(self, tau, tau_bulk=None, magic=0.25):
        """Per-moment relaxation-rate vector s (length Q).

        Shear moments relax at s_nu = 1/tau (sets the viscosity); conserved
        moments at 0; the energy moment at 1/tau_bulk (bulk viscosity,
        defaults to tau). Remaining ghost moments use a TRT-style split:
        even-parity ghosts at s_nu, odd-parity ghosts at the "magic"
        rate with Lambda = (1/s_nu - 1/2)(1/s_odd - 1/2) = 1/4, which places
        bounce-back walls exactly halfway and is the standard robust choice
        (Ginzburg's TRT). The reference instead hard-codes per-grid tuned
        rates in its MRT matrices (sailfish/sym.py:86-226); the TRT-magic
        assignment is equivalent in the hydrodynamic limit and strictly more
        stable than naive constant ghost rates (which are linearly unstable
        for the even 4th-order moment when s_nu approaches 2).
        """
        if tau_bulk is None:
            tau_bulk = tau
        s_nu = 1.0 / tau
        lam_nu = tau - 0.5                       # 1/s_nu - 1/2
        s_odd = 1.0 / (magic / lam_nu + 0.5)
        s = np.where(self.mrt_parity > 0, s_nu, s_odd)
        s[self.mrt_conserved] = 0.0
        s[self.mrt_shear] = s_nu
        s[self.mrt_energy] = 1.0 / tau_bulk
        return s

    # -- misc tables --------------------------------------------------------

    @functools.cached_property
    def orientation_vectors(self):
        """(2*dim, dim) unit vectors ordered (+x,-x,+y,-y[,+z,-z]).

        Orientation id k (1-based in node codes, 0 = none) maps to row k-1.
        Used for node orientations (reference: sailfish/node_type.py
        needs_orientation; subdomain.py:644 orientation autodetection).
        These need not be members of the lattice basis (D3Q13 has no
        axis-aligned velocities).
        """
        out = []
        for axis in range(self.dim):
            for sign in (1, -1):
                v = [0] * self.dim
                v[axis] = sign
                out.append(v)
        return np.array(out, dtype=np.int32)

    def _index_of(self, vec):
        for i, b in enumerate(self.basis.tolist()):
            if b == list(vec):
                return i
        raise KeyError(vec)

    def unknown_mask(self, orientation_vec):
        """Boolean (Q,) mask of distributions unknown at a boundary whose
        inward normal (pointing into the fluid) is ``orientation_vec``.

        A distribution f_i is unknown when its pull source x - c_i lies
        outside the fluid, i.e. c_i . n > 0. Counterpart of
        sym.get_missing_dists (sailfish/sym.py:534).
        """
        n = np.asarray(orientation_vec)
        return (self.basis @ n) > 0

    def slip_swap(self, axis):
        """Permutation reflecting the velocity component along ``axis``
        (specular / free-slip reflection; cf. sym.slip_bb_swap_pairs,
        sailfish/sym.py:481)."""
        idx = {tuple(v): i for i, v in enumerate(self.basis.tolist())}
        perm = np.arange(self.Q, dtype=np.int32)
        for i, v in enumerate(self.basis.tolist()):
            w = list(v)
            w[axis] = -w[axis]
            perm[i] = idx[tuple(w)]
        return perm

    def __repr__(self):
        return f'<Grid {self.name}>'


def _make_d2q9():
    vecs = _sorted_vectors(itertools.product((-1, 0, 1), repeat=2))
    # itertools gives (cx, cy) pairs already
    w = {0: 4.0 / 9.0, 1: 1.0 / 9.0, 2: 1.0 / 36.0}
    weights = [w[sum(c * c for c in v)] for v in vecs]
    return Grid('D2Q9', 2, vecs, weights)


def _make_d3(name, shells):
    """shells: dict |c|^2 -> weight. Vector components are (cx, cy, cz)."""
    vecs = [v for v in _sorted_vectors(itertools.product((-1, 0, 1), repeat=3))
            if sum(c * c for c in v) in shells]
    weights = [shells[sum(c * c for c in v)] for v in vecs]
    return Grid(name, 3, vecs, weights)


D2Q9 = _make_d2q9()
D3Q13 = _make_d3('D3Q13', {0: 1.0 / 2.0, 2: 1.0 / 24.0})
D3Q15 = _make_d3('D3Q15', {0: 2.0 / 9.0, 1: 1.0 / 9.0, 3: 1.0 / 72.0})
D3Q19 = _make_d3('D3Q19', {0: 1.0 / 3.0, 1: 1.0 / 18.0, 2: 1.0 / 36.0})
D3Q27 = _make_d3('D3Q27', {0: 8.0 / 27.0, 1: 2.0 / 27.0, 2: 1.0 / 54.0,
                           3: 1.0 / 216.0})

KNOWN_GRIDS = {g.name: g for g in (D2Q9, D3Q13, D3Q15, D3Q19, D3Q27)}


def get_grid(name):
    try:
        return KNOWN_GRIDS[name]
    except KeyError:
        raise ValueError(f'unknown grid {name!r}; known: {sorted(KNOWN_GRIDS)}')


def relaxation_time(visc, cs2=1.0 / 3.0):
    """tau = nu/cs^2 + 1/2 (reference: sym.relaxation_time, sym.py:847)."""
    return visc / cs2 + 0.5
