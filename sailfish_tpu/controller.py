"""LBSimulationController: config parsing, geometry, launch.

API-compatible counterpart of the reference's ``sailfish/controller.py``
(LBSimulationController :272, run :788, option groups :297-464). The
reference's machine-master/execnet/zmq process tree collapses into a
single JAX process: devices come from ``jax.devices()`` and multi-chip
runs shard the domain over a ``jax.sharding.Mesh``.
"""

from __future__ import annotations

import sys

import numpy as np

from sailfish_tpu import geo as geo_mod
from sailfish_tpu import io as sio
from sailfish_tpu import util
from sailfish_tpu.config import LBConfigParser
from sailfish_tpu.runner import SubdomainRunner


class LBGeometryProcessor:
    """Assigns ids and connects subdomain specs (reference controller.py:130).

    Adjacency is implied by the mesh layout; this class validates the
    decomposition and computes the mesh shape."""

    def __init__(self, subdomains, dim, geo):
        self.subdomains = subdomains
        self.dim = dim
        self.geo = geo

    def transform(self, config):
        for i, s in enumerate(self.subdomains):
            s.id = i
        return self.subdomains


class LBSimulationController:
    """Main entry point (reference controller.py:272-830)."""

    def __init__(self, lb_class, lb_geo=None, default_config=None):
        self.lb_class = lb_class
        self._default_config = default_config or {}
        self.config_parser = LBConfigParser()
        self.dim = lb_class.subdomain.dim
        self._lb_geo = lb_geo

        group = self.config_parser.add_group('Runtime')
        group.add_argument('--mode', type=str, default='batch',
                           choices=['batch', 'benchmark', 'visualization'])
        group.add_argument('--every', type=int, default=100,
                           help='iterations between output/logging')
        group.add_argument('--from', dest='from_', type=int, default=0)
        group.add_argument('--max_iters', type=int, default=0,
                           help='number of iterations to run')
        group.add_argument('--init_iters', type=int, default=0,
                           help='number of consistent-initialization '
                           'iterations (nu=1/6 warmup establishing the '
                           'initial pressure field; <= 0 disables; '
                           'reference controller.py:312)')
        group.add_argument('--output', type=str, default='',
                           help='output file base name')
        group.add_argument('--base_name', type=str, default='',
                           help='default base name for --log, --output '
                           'and --checkpoint_file when those are unset '
                           '(reference controller.py:351-353,778-786)')
        group.add_argument('--debug_dump_dists', action='store_true',
                           default=False,
                           help='dump the raw distribution arrays to '
                           'files at every output event (reference '
                           'controller.py:335-337)')
        group.add_argument('--debug_dump_node_type_map',
                           action='store_true', default=False,
                           help='dump the node type map into a file '
                           'at initialization (reference '
                           'controller.py:343-345)')
        group.add_argument('--output_format', type=str, default='npy',
                           choices=sorted(sio.FORMATS))
        group.add_argument('--nooutput_compress', action='store_false',
                           dest='output_compress', default=True,
                           help='write uncompressed npz output '
                           '(reference io.py:306-310; compression is '
                           'the default there and here)')
        group.add_argument('--log', type=str, default='')
        group.add_argument('--loglevel', type=str, default='info')
        group.add_argument('--precision', type=str, default='single',
                           choices=['single', 'double', 'mixed'],
                           help='mixed = distributions rounded to an '
                                'int16 fixed-point grid every step, fp32 '
                                'math and fp32 carry (ops/mixed.py)')
        group.add_argument('--mixed_range', type=float, default=0.5,
                           help='--precision=mixed: max |f/w - 1| the '
                                'int16 grid covers; deviations beyond '
                                'it saturate')
        group.add_argument('--seed', type=int, default=0)
        group.add_argument('--grid', type=str, default='',
                           help='lattice type (D2Q9, D3Q19, ...)')
        group.add_argument('--access_pattern', type=str, default='AB',
                           choices=['AB', 'AA'],
                           help='accepted for compatibility; the step '
                                'always uses donated AB buffers')
        group.add_argument('--node_addressing', type=str, default='direct',
                           choices=['direct', 'indirect'])
        group.add_argument('--nouse_link_tags', action='store_false',
                           dest='use_link_tags', default=True,
                           help='disable per-link tagging for node types '
                           'that support it (HalfBB/TMS walls) and fall '
                           'back to the cruder orientation-vector tagging '
                           '(reference lb_base.py:86-92); identical on '
                           'flat walls, differs at corners/edges')
        group.add_argument('--block_size', type=int, default=128,
                           help='accepted for compatibility (CUDA block)')
        group.add_argument('--check_invalid_results_gpu', action='store_true',
                           default=False)
        group.add_argument('--check_invalid_results_host',
                           action='store_true', default=False)
        group.add_argument('--compress_intersubdomain_data',
                           action='store_true', default=False)
        group.add_argument('--profile_trace', type=str, default='',
                           help='write a jax.profiler device trace '
                           '(XPlane/TensorBoard) of the main loop to '
                           'this directory')
        group.add_argument('--mesh', type=str, default='',
                           help='device mesh shape, e.g. "4" or "2x2"; '
                                'empty = single device')
        group.add_argument('--vis_engine', type=str, default='mpl',
                           help='visualization engine for '
                                '--mode=visualization')
        group.add_argument('--platform', type=str, default='',
                           help='force a JAX platform (e.g. "cpu", "gpu")')

        group = self.config_parser.add_group('Cluster')
        group.add_argument('--cluster', action='store_true', default=False,
                           help='multi-host run: call '
                                'jax.distributed.initialize before device '
                                'use (flags below override scheduler env '
                                'autodetection)')
        group.add_argument('--coordinator_address', type=str, default='')
        group.add_argument('--num_processes', type=int, default=0)
        group.add_argument('--process_id', type=int, default=-1)

        group = self.config_parser.add_group('Checkpointing')
        group.add_argument('--checkpoint_file', type=str, default='')
        group.add_argument('--checkpoint_every', type=int, default=0)
        group.add_argument('--checkpoint_from', type=int, default=0)
        group.add_argument('--restore_from', type=str, default='')
        group.add_argument('--norestore_time', action='store_false',
                           dest='restore_time', default=True,
                           help='restore the distributions from the '
                           'checkpoint but restart the iteration counter '
                           'at 0 (reference controller.py:418-422, '
                           'subdomain_runner.py:1438-1440)')
        group.add_argument('--final_checkpoint', action='store_true',
                           default=False)
        group.add_argument('--single_checkpoint', action='store_true',
                           default=False)

        group = self.config_parser.add_group('Benchmarking')
        group.add_argument('--perf_stats_every', type=int, default=100)
        group.add_argument('--benchmark_sample_from', type=int, default=1000)
        group.add_argument('--benchmark_minibatch', type=int, default=50)

        group = self.config_parser.add_group('Geometry')
        group.add_argument('--lat_nx', type=int, default=64)
        group.add_argument('--lat_ny', type=int, default=64)
        group.add_argument('--lat_nz', type=int, default=1)
        group.add_argument('--periodic_x', action='store_true', default=False)
        group.add_argument('--periodic_y', action='store_true', default=False)
        group.add_argument('--periodic_z', action='store_true', default=False)

        lb_geo = self._geo_class()
        group = self.config_parser.add_group('Decomposition')
        lb_geo.add_options(group, self.dim)

        group = self.config_parser.add_group(
            f'{lb_class.__name__} simulation')
        for klass in reversed(lb_class.mro()):
            if hasattr(klass, 'add_options') and \
                    'add_options' in vars(klass):
                klass.add_options(group, self.dim)

    def _geo_class(self):
        if self._lb_geo is not None:
            return self._lb_geo
        return (geo_mod.LBGeometry2D if self.dim == 2
                else geo_mod.LBGeometry3D)

    def run(self, ignore_cmdline=False):
        args = [] if ignore_cmdline else sys.argv[1:]
        defaults = {}
        self.lb_class.update_defaults(defaults)
        defaults.update(self._default_config)
        config = self.config_parser.parse(args, internal_defaults=defaults)
        self.config = config
        self.lb_class.modify_config(config)
        if getattr(config, 'base_name', ''):
            # --base_name fills unset file options (reference
            # controller.py:778-786)
            if not config.log:
                config.log = config.base_name + '.log'
            if not config.output:
                config.output = config.base_name
            if not config.checkpoint_file:
                config.checkpoint_file = config.base_name
        import jax
        if config.platform:
            jax.config.update('jax_platforms', config.platform)
        # set BOTH ways: x64 is process-global in JAX, and a stale
        # True from an earlier double-precision run changes weak-type
        # promotion inside fp32 kernels (int32/int64 mixes)
        jax.config.update('jax_enable_x64',
                          config.precision == 'double')
        if config.cluster:
            # multi-host bootstrap (replaces the reference's
            # execnet/PBS/LSF machinery, controller.py:496-658)
            util.init_distributed(config, util.get_logger(config))
        util.enable_compile_cache()
        if config.seed:
            np.random.seed(config.seed)
        util.reset_logger()
        log = util.get_logger(config)
        if config.node_addressing == 'indirect':
            log.warning(
                'node_addressing=indirect is not implemented: every '
                'node is stored and updated densely. Running dense.')

        geo = self._geo_class()(config)
        proc = LBGeometryProcessor(geo.subdomains(), self.dim, geo)
        proc.transform(config)
        log.info('simulation: %s, domain %s, %d subdomain spec(s)',
                 self.lb_class.__name__,
                 'x'.join(str(s) for s in reversed(
                     (config.lat_ny, config.lat_nx) if self.dim == 2 else
                     (config.lat_nz, config.lat_ny, config.lat_nx))),
                 len(proc.subdomains))

        sim = self.lb_class(config)
        output = None
        if config.output:
            output_cls = sio.format_name_to_cls(config.output_format)
            output = output_cls(config)
        runner = SubdomainRunner(sim, geo, output=output)
        if output is not None:
            self._register_output_fields(sim, output)
        if config.mode == 'visualization':
            from sailfish_tpu.vis import engine_by_name
            engine_cls = engine_by_name(config.vis_engine)
            runner._vis = engine_cls(config, lambda: sim.host_fields())
        self._runner = runner
        timing = runner.run()
        if config.mode == 'benchmark' and timing is not None:
            log.info('performance: %.2f MLUPS (sampled from iteration %d)',
                     timing.mlups, config.benchmark_sample_from)
        self.timing = timing
        return timing

    def _register_output_fields(self, sim, output):
        # register after init so arrays exist; runner re-syncs before save
        orig_init = sim.init_fields

        def patched(shape):
            orig_init(shape)
            for name, field in sim.host_fields().items():
                output.register_field(field, name,
                                      vector=isinstance(field, list))
        sim.init_fields = patched
