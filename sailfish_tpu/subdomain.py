"""Scene/geometry API: Subdomain2D/3D node-type map construction.

API-compatible counterpart of the reference's ``sailfish/subdomain.py``
(SubdomainSpec :32, Subdomain :350, set_node/update_node :532,561,
orientation autodetection :644, link tagging :593). Users subclass
Subdomain2D/3D and override ``boundary_conditions(hx, hy[, hz])`` and
``initial_conditions(sim, hx, hy[, hz])`` exactly as in the reference.

All construction is host-side numpy preprocessing. The output is a set of
dense per-node arrays (type id, orientation, link-tag bitmask, parameter
fields) that the step consumes as packed data -- the one reference
design we deliberately mirror, since it is a data format, not an
architecture (cf. geo_encoder.py:365-382).
"""

from __future__ import annotations

import numpy as np

from sailfish_tpu import node_type as nt


class SubdomainSpec:
    """A box in the global lattice (reference subdomain.py:32-304).

    Here a spec maps to one shard of the device mesh rather than to a
    process+GPU; the controller keeps the same (location, size) interface
    so geometry classes and cluster-era scripts keep working.
    """

    dim = None

    def __init__(self, location, size, envelope_size=1, id_=None):
        self.location = tuple(location)
        self.size = tuple(size)
        self.envelope_size = envelope_size
        self.id = id_

    def __repr__(self):
        return f'{self.__class__.__name__}({self.location}, {self.size}, ' \
               f'id_={self.id})'

    @property
    def num_nodes(self):
        return int(np.prod(self.size))

    @property
    def end_location(self):
        return tuple(l + s for l, s in zip(self.location, self.size))


class SubdomainSpec2D(SubdomainSpec):
    dim = 2

    @property
    def nx(self):
        return self.size[0]

    @property
    def ny(self):
        return self.size[1]

    @property
    def ox(self):
        return self.location[0]

    @property
    def oy(self):
        return self.location[1]


class SubdomainSpec3D(SubdomainSpec):
    dim = 3

    @property
    def nx(self):
        return self.size[0]

    @property
    def ny(self):
        return self.size[1]

    @property
    def nz(self):
        return self.size[2]

    @property
    def ox(self):
        return self.location[0]

    @property
    def oy(self):
        return self.location[1]

    @property
    def oz(self):
        return self.location[2]


class NodeMaps:
    """Encoded per-node arrays consumed by the device step.

    Attributes (all numpy, spatial shape S = (gy, gx) or (gz, gy, gx)):
      type_map: int32 node-type id.
      orientation: int32, 0 = none, 1..2*dim = (+x,-x,+y,-y,+z,-z).
      link_tags: int32 bitmask; bit i set => incoming f_i is missing
                 (its pull source is not a wet node).
      param_rho: float64 prescribed density (density BCs), default 1.
      param_vel: (dim,)+S float64 prescribed velocity (velocity BCs).
      param_scalar: float64 misc scalar parameter (alpha, gradient, ...).
      present_types: sorted list of type ids present (static; selects which
                 BC transforms get traced into the step).
    """

    def __init__(self, shape, dim):
        self.type_map = np.zeros(shape, dtype=np.int32)
        self.orientation = np.zeros(shape, dtype=np.int32)
        self.link_tags = np.zeros(shape, dtype=np.int32)
        self.param_rho = np.ones(shape, dtype=np.float64)
        self.param_vel = np.zeros((dim,) + shape, dtype=np.float64)
        self.param_scalar = np.zeros(shape, dtype=np.float64)
        #: list of (mask, param_name, exprs) for DynamicValue params
        self.dynamic = []
        #: list of (mask, 4x4 transformation) for NTExtendedCopy instances
        self.extended = []
        self.dim = dim

    @property
    def present_types(self):
        return sorted(int(i) for i in np.unique(self.type_map))


class Subdomain:
    """Base class for user geometry definitions (reference subdomain.py:350).

    The spatial shape convention is numpy-style (.., z, y, x); the index
    arrays handed to ``boundary_conditions``/``initial_conditions`` are
    full mgrid arrays of global coordinates, exactly like the reference's
    hx/hy/hz.
    """

    dim = None

    def __init__(self, grid_shape, spec, grid, config):
        """grid_shape: (gy, gx) or (gz, gy, gx); spec: SubdomainSpec;
        grid: lattice.Grid; config: LBConfig."""
        self.spec = spec
        self.grid = grid
        self.config = config
        self.shape = tuple(grid_shape)
        self.maps = NodeMaps(self.shape, self.dim)
        # per-type-instance bookkeeping for orientation overrides
        self._explicit_orientation = np.zeros(self.shape, dtype=bool)

    # -- user-facing dimensions (match reference naming) --------------------

    @property
    def gx(self):
        return self.shape[-1]

    @property
    def gy(self):
        return self.shape[-2]

    @property
    def gz(self):
        assert self.dim == 3
        return self.shape[-3]

    def _get_mgrid(self):
        """Global coordinate arrays, ordered (hx, hy[, hz]) for the user."""
        if self.dim == 2:
            hy, hx = np.mgrid[0:self.gy, 0:self.gx]
            return hx, hy
        hz, hy, hx = np.mgrid[0:self.gz, 0:self.gy, 0:self.gx]
        return hx, hy, hz

    # -- node setting (reference subdomain.py:532-592) ----------------------

    def set_node(self, where, node_t):
        """Set nodes selected by boolean array ``where`` to ``node_t``
        (a node-type class or instance)."""
        if isinstance(node_t, type):
            node_t = node_t()
        assert np.all(self.maps.type_map[where] == 0), \
            'set_node called twice on the same node; use update_node'
        self._assign(where, node_t)

    def update_node(self, where, node_t):
        """Like set_node but allows changing already-set nodes
        (reference subdomain.py:561)."""
        if isinstance(node_t, type):
            node_t = node_t()
        self._assign(where, node_t)

    def _assign(self, where, node_t):
        m = self.maps
        m.type_map[where] = node_t.id
        if node_t.orientation is not None:
            m.orientation[where] = self._orientation_id(node_t.orientation)
            self._explicit_orientation[where] = True
        self._assign_params(where, node_t)

    def _orientation_id(self, vec):
        ov = self.grid.orientation_vectors
        for k in range(len(ov)):
            if np.all(ov[k] == np.asarray(vec)):
                return k + 1
        raise ValueError(f'orientation {vec} is not a primary direction')

    def _assign_params(self, where, node_t):
        m = self.maps
        params = node_t.params
        if not params:
            return
        for name, val in params.items():
            if isinstance(val, nt.DynamicValue):
                mask = np.zeros(self.shape, dtype=bool)
                mask[where] = True
                m.dynamic.append((mask, name, tuple(val.exprs)))
                self.config.time_dependence = True
                continue
            if name == 'density':
                self._fill(m.param_rho, where, val)
            elif name == 'velocity':
                if isinstance(val, np.recarray) or (
                        isinstance(val, np.ndarray) and val.dtype.names):
                    for a, fname in enumerate(val.dtype.names):
                        m.param_vel[a][where] = val[fname]
                elif isinstance(val, (tuple, list)):
                    for a, comp in enumerate(val):
                        self._fill(m.param_vel[a], where, comp)
                else:
                    raise ValueError('velocity must be a tuple or multifield')
            elif name in ('alpha', 'gradient'):
                self._fill(m.param_scalar, where, val)
            elif name == 'transformation':
                mask = np.zeros(self.shape, dtype=bool)
                mask[where] = True
                m.extended.append((mask, np.asarray(val, dtype=np.float64)))
            else:
                raise ValueError(f'unknown BC parameter {name!r}')

    @staticmethod
    def _fill(arr, where, val):
        if isinstance(val, np.ndarray) and val.shape == arr.shape:
            arr[where] = val[where]
        else:
            arr[where] = val

    # -- postprocessing -----------------------------------------------------

    def _wet_map(self):
        wet = np.zeros(self.shape, dtype=bool)
        for tid in self.maps.present_types:
            if nt.get_node_type(tid).wet_node:
                wet |= self.maps.type_map == tid
        return wet

    def _shift_map(self, arr, vec, fill):
        """Value of ``arr`` at node + vec (vec in (cx, cy[, cz]) order),
        honoring per-axis periodicity; ``fill`` used at non-periodic edges."""
        periodic = [self.config.periodic_x, self.config.periodic_y]
        if self.dim == 3:
            periodic.append(self.config.periodic_z)
        out = arr
        # spatial axes are (.., z, y, x) = axis -(a+1) for component a
        for a, comp in enumerate(vec):
            if comp == 0:
                continue
            axis = arr.ndim - 1 - a
            out = np.roll(out, -int(comp), axis=axis)
            if not periodic[a]:
                sl = [slice(None)] * arr.ndim
                if comp > 0:
                    sl[axis] = slice(arr.shape[axis] - comp, arr.shape[axis])
                else:
                    sl[axis] = slice(0, -comp)
                out = out.copy()
                out[tuple(sl)] = fill
        return out

    def _detect_orientation(self):
        """Autodetect orientation for needs_orientation nodes without an
        explicit one: the first primary direction whose neighbor is wet
        (reference subdomain.py:644-674)."""
        m = self.maps
        need = np.zeros(self.shape, dtype=bool)
        for tid in m.present_types:
            if nt.get_node_type(tid).needs_orientation:
                need |= m.type_map == tid
        need &= ~self._explicit_orientation
        if not need.any():
            return
        wet = self._wet_map()
        fluid = m.type_map == nt._NTFluid.id
        # Prefer a fluid neighbor; fall back to any wet neighbor.
        for target in (fluid, wet):
            undecided = need & (m.orientation == 0)
            if not undecided.any():
                break
            for k, vec in enumerate(self.grid.orientation_vectors):
                neigh = self._shift_map(target, vec, False)
                sel = undecided & neigh & (m.orientation == 0)
                m.orientation[sel] = k + 1

    def _detect_link_tags(self):
        """Tag incoming-missing links for link_tags node types: bit i set
        when the pull source (x - c_i) of f_i is not a wet node
        (reference subdomain.py:593-643)."""
        m = self.maps
        tagged_types = [tid for tid in m.present_types
                        if nt.get_node_type(tid).link_tags]
        if not tagged_types:
            return
        sel = np.isin(m.type_map, tagged_types)
        if not getattr(self.config, 'use_link_tags', True):
            # --nouse_link_tags: crude orientation tagging (reference
            # lb_base.py:86-92) -- tag every link pointing along the
            # node's orientation vector into the wall instead of
            # probing per-link wetness. Identical on flat walls;
            # differs at corners/edges (the point of the escape).
            lut = np.zeros(len(self.grid.orientation_vectors) + 1,
                           dtype=np.int32)
            for k, vec in enumerate(self.grid.orientation_vectors):
                bits = 0
                for i in range(1, self.grid.Q):
                    # orientation points wall -> fluid; f_i whose pull
                    # source lies inside the wall has c_i . n > 0
                    if int(np.dot(self.grid.basis[i], vec)) > 0:
                        bits |= 1 << i
                lut[k + 1] = bits
            m.link_tags[sel] = lut[m.orientation[sel]]
            return
        wet = self._wet_map()
        tags = np.zeros(self.shape, dtype=np.int32)
        for i in range(1, self.grid.Q):
            src_wet = self._shift_map(wet, -self.grid.basis[i], False)
            tags |= np.where(~src_wet, np.int32(1 << i), np.int32(0))
        m.link_tags[sel] = tags[sel]

    def reset(self):
        """Build the complete node map: user BCs + postprocessing."""
        self.boundary_conditions(*self._get_mgrid())
        self._detect_orientation()
        self._detect_link_tags()

    def select_subdomain(self, array, *coords):
        """Slice a global array down to this subdomain's extent
        (reference subdomain.py select_subdomain). This build keeps the
        whole domain in one logical subdomain, so this slices by the spec
        location/size (identity for the default geometry)."""
        sl = []
        for a in range(self.dim):
            lo = self.spec.location[self.dim - 1 - a]
            size = self.shape[a]
            sl.append(slice(lo, lo + size))
        return array[tuple(sl)]

    # -- user overrides ------------------------------------------------------

    def boundary_conditions(self, *args):
        pass

    def initial_conditions(self, sim, *args):
        pass


class Subdomain2D(Subdomain):
    dim = 2


class Subdomain3D(Subdomain):
    dim = 3
