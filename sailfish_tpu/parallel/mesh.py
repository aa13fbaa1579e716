"""Device mesh construction and domain sharding.

Replacement for the reference's multi-process communication
stack (``sailfish/master.py``, ``connector.py``, ``socketserver.py``: one
process per GPU + ZeroMQ ghost exchange + execnet bootstrap). Here the
domain is a single jit-global array sharded over a ``jax.sharding.Mesh``;
XLA's SPMD partitioner turns the streaming shifts into collective permutes
(NCCL on GPUs), replacing collect/distribute kernels, port negotiation and zmq
entirely (SURVEY.md section 2.6).

Axis convention: spatial array axes are (z, y, x) with x innermost; mesh
axes are named after the spatial axes they shard. Outer axes are sharded
first ('z' then 'y'), so each shard's x rows stay contiguous.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def parse_mesh_shape(mesh_str, dim, n_devices=None):
    """'4' -> (4,); '2x2' -> (2, 2); '' -> None. Shapes are listed
    outer-to-inner over spatial axes (z, y, x) in 3D / (y, x) in 2D."""
    if not mesh_str:
        return None
    shape = tuple(int(p) for p in mesh_str.lower().split('x'))
    max_axes = 3 if dim == 3 else 2
    if len(shape) > max_axes:
        raise ValueError(
            f'mesh {mesh_str!r} has {len(shape)} axes; at most {max_axes} '
            f'spatial axes are sharded in {dim}D')
    return shape


def make_mesh(shape, dim, devices=None):
    """Create a Mesh over the first len(shape) spatial axes."""
    if devices is None:
        devices = jax.devices()
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f'mesh {shape} needs {n} devices; '
                         f'only {len(devices)} available')
    axis_names = _axis_names(dim)[:len(shape)]
    dev_array = np.asarray(devices[:n]).reshape(shape)
    return Mesh(dev_array, axis_names)


def _axis_names(dim):
    """Mesh axis names outer-to-inner."""
    return ('z', 'y', 'x') if dim == 3 else ('y', 'x')


def dist_spec(mesh, dim):
    """PartitionSpec for a (Q, [z,] y, x) distribution array."""
    names = [None]  # Q axis replicated
    names += _spatial_names(mesh, dim)
    return P(*names)


def field_spec(mesh, dim, leading=0):
    """PartitionSpec for a ([components,]*leading, [z,] y, x) field."""
    return P(*([None] * leading + _spatial_names(mesh, dim)))


def _spatial_names(mesh, dim):
    names = []
    spatial = ('z', 'y', 'x') if dim == 3 else ('y', 'x')
    for ax in spatial:
        names.append(ax if ax in mesh.axis_names else None)
    return names


def shard_dists(f, mesh, dim):
    return jax.device_put(f, NamedSharding(mesh, dist_spec(mesh, dim)))


def shard_field(arr, mesh, dim):
    lead = arr.ndim - dim
    return jax.device_put(arr, NamedSharding(mesh, field_spec(mesh, dim,
                                                              lead)))


def validate_divisible(shape_spatial, mesh):
    """Spatial dims sharded by the mesh must divide evenly (static shapes
    keep XLA partitioning tight; mirror of the reference's equal-subdomain
    requirement, geo.py:69-135)."""
    dim = len(shape_spatial)
    spatial = ('z', 'y', 'x') if dim == 3 else ('y', 'x')
    for ax_name, size in zip(spatial, shape_spatial):
        if ax_name in mesh.axis_names:
            n = mesh.shape[ax_name]
            if size % n != 0:
                raise ValueError(
                    f'domain axis {ax_name} (size {size}) not divisible by '
                    f'mesh axis {ax_name} ({n} devices)')
