"""Logging, timing, misc helpers (counterpart of sailfish/util.py)."""

from __future__ import annotations

import logging
import os
from collections import namedtuple

import numpy as np

TimingInfo = namedtuple('TimingInfo', ('iters', 'elapsed', 'mlups'))


class SimpleEvent:
    """Single-process stand-in for multiprocessing.Event (the reference's
    quit_event; master.py:94-97)."""

    def __init__(self):
        self._flag = False

    def set(self):
        self._flag = True

    def is_set(self):
        return self._flag

    def clear(self):
        self._flag = False


class TimingStats:
    """Aggregates per-phase wall times (reference profile.py:54-103)."""

    def __init__(self):
        self.phases = {}

    def add(self, phase, dt):
        self.phases.setdefault(phase, []).append(dt)

    def summary(self):
        return {k: (float(np.mean(v)), float(np.min(v)), float(np.max(v)),
                    float(np.std(v)))
                for k, v in self.phases.items()}


#: Compile cache used when JAX_COMPILATION_CACHE_DIR is unset: a fixed
#: directory inside the checkout. The path is part of JAX's cache key, so
#: it must not move between runs.
DEFAULT_COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    '.jax_cache')


def compile_cache_dir():
    """The directory of the persistent compile cache for accelerator
    programs."""
    return os.environ.get('JAX_COMPILATION_CACHE_DIR') or \
        DEFAULT_COMPILE_CACHE_DIR


def enable_compile_cache():
    """Enable JAX's persistent compilation cache, so that a repeated run
    of the same configuration skips compiling its step. Where
    JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
    changed here; otherwise accelerator programs are cached in
    DEFAULT_COMPILE_CACHE_DIR. CPU programs are not: XLA:CPU checks a
    cached program's target features against the host's when it loads
    it, and its own tuning features fail that check on the machine that
    wrote them. Returns the directory in use, or None."""
    if os.environ.get('JAX_COMPILATION_CACHE_DIR'):
        return compile_cache_dir()
    import jax
    if jax.default_backend() == 'cpu':
        return None
    os.makedirs(DEFAULT_COMPILE_CACHE_DIR, exist_ok=True)
    jax.config.update('jax_compilation_cache_dir', DEFAULT_COMPILE_CACHE_DIR)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 1.0)
    return DEFAULT_COMPILE_CACHE_DIR


def gpu_cards():
    """``name, power.limit`` of each NVIDIA card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them. Runs in a child process and does not touch JAX."""
    import subprocess
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError('nvidia-smi listed no card')
    return lines


def require_gpu(devices):
    """Refuse any JAX platform but ``gpu``: a measurement must never
    report another platform's numbers under a GPU's name."""
    platform = devices[0].platform
    if platform != 'gpu':
        raise SystemExit(f'JAX platform is {platform!r}, not \'gpu\'; '
                         'this measurement runs on NVIDIA cards only')


_logger = None


def get_logger(config=None):
    """Console+file logger (reference util.py:187-213)."""
    global _logger
    if _logger is not None:
        return _logger
    logger = logging.getLogger('sailfish_tpu')
    logger.setLevel(logging.DEBUG)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            '[%(relativeCreated)6.0f %(levelname)5s] %(message)s'))
        logger.addHandler(handler)
        if config is not None and getattr(config, 'log', None):
            fh = logging.FileHandler(config.log)
            logger.addHandler(fh)
    if config is not None:
        if getattr(config, 'silent', False):
            logger.setLevel(logging.ERROR)
        elif getattr(config, 'quiet', False):
            logger.setLevel(logging.WARNING)
        elif getattr(config, 'verbose', False):
            logger.setLevel(logging.DEBUG)
        else:
            logger.setLevel(logging.INFO)
    _logger = logger
    return logger


def reset_logger():
    global _logger
    _logger = None


def kinetic_energy(vfield):
    """Mean kinetic energy of a (dim, ...) velocity field
    (reference util.py:215-230)."""
    return float(np.mean(np.sum(np.square(vfield), axis=0))) / 2.0


def vorticity2d(vx, vy):
    dvy_dx = np.gradient(vy, axis=-1)
    dvx_dy = np.gradient(vx, axis=-2)
    return dvy_dx - dvx_dy


def enstrophy2d(vx, vy):
    w = vorticity2d(vx, vy)
    return float(np.mean(w * w)) / 2.0


def energy_spectrum(vfield):
    """Isotropic kinetic-energy spectrum (reference util.py:231-292)."""
    dim = vfield.shape[0]
    ks = None
    e_k = None
    fts = [np.fft.fftn(vfield[a]) for a in range(dim)]
    mag = sum(np.abs(ft) ** 2 for ft in fts)
    shape = vfield.shape[1:]
    grids = np.meshgrid(*[np.fft.fftfreq(n) * n for n in shape],
                        indexing='ij')
    kmag = np.sqrt(sum(g * g for g in grids))
    kbins = np.arange(0.5, int(np.max(shape) // 2) + 1)
    which = np.digitize(kmag.flat, kbins)
    e = np.zeros(len(kbins) + 1)
    np.add.at(e, which, mag.flat)
    return e[1:-1] / (2.0 * np.prod(shape))


def cluster_env_spec():
    """Autodetect a multi-host launch from scheduler environment
    variables (counterpart of the reference's PBS/LSF cluster-spec
    detection, util.py:92-128, repurposed for jax.distributed).

    Returns (coordinator_address, num_processes, process_id) with None
    entries for anything the environment does not determine."""
    env = os.environ

    # SLURM (srun)
    if 'SLURM_PROCID' in env and 'SLURM_NTASKS' in env:
        coord = None
        nodelist = env.get('SLURM_STEP_NODELIST',
                           env.get('SLURM_NODELIST', ''))
        if nodelist:
            # first hostname of the (possibly compressed) node list
            head = nodelist.split(',')[0]
            if '[' in head:
                prefix, rng = head.split('[', 1)
                head = prefix + rng.split('-')[0].split(',')[0].rstrip(']')
            coord = head + ':8476'
        return coord, int(env['SLURM_NTASKS']), int(env['SLURM_PROCID'])

    # OpenMPI / mpirun
    if 'OMPI_COMM_WORLD_SIZE' in env:
        return (None, int(env['OMPI_COMM_WORLD_SIZE']),
                int(env['OMPI_COMM_WORLD_RANK']))

    # generic PMI rank (set by pbsdsh/blaunch/mpiexec process managers);
    # a scheduler allocation alone carries no per-process rank, so
    # without one of these the caller must pass --process_id explicitly
    def pmi_rank():
        for var in ('PMIX_RANK', 'PMI_RANK'):
            if var in env:
                return int(env[var])
        return None

    # PBS: the node file lists one line per allocated slot; rank comes
    # from pbsdsh (PBS_TASKNUM/PBS_VNODENUM) or the PMI layer
    if 'PBS_NODEFILE' in env:
        try:
            with open(env['PBS_NODEFILE']) as nf:
                hosts = [l.strip() for l in nf if l.strip()]
        except OSError:
            hosts = []
        if hosts:
            num = len(hosts)
            pid = pmi_rank()
            for var in ('PBS_TASKNUM', 'PBS_VNODENUM'):
                if pid is None and var in env:
                    pid = int(env[var])
            if pid is None:
                return hosts[0] + ':8476', num, None
            return hosts[0] + ':8476', num, pid

    # LSF: one LSB_HOSTS entry per slot; blaunch sets LSF_PM_TASKID
    # (1-based)
    if 'LSB_HOSTS' in env:
        hosts = env['LSB_HOSTS'].split()
        if hosts:
            pid = pmi_rank()
            if pid is None and 'LSF_PM_TASKID' in env:
                pid = int(env['LSF_PM_TASKID']) - 1
            return hosts[0] + ':8476', len(hosts), pid

    return None, None, None


def init_distributed(config, log=None):
    """Multi-host bootstrap: jax.distributed.initialize driven by
    explicit flags or scheduler env autodetection (the
    replacement for the reference's execnet/SSH cluster startup,
    controller.py:496-658). Returns True if initialization ran."""
    import jax

    coord = getattr(config, 'coordinator_address', '') or None
    num = getattr(config, 'num_processes', 0) or None
    pid = getattr(config, 'process_id', -1)
    pid = None if pid is None or pid < 0 else pid
    if coord is None or num is None or pid is None:
        auto = cluster_env_spec()
        coord = coord or auto[0]
        num = num if num is not None else auto[1]
        pid = pid if pid is not None else auto[2]
    if num is not None and num > 1 and pid is None:
        raise RuntimeError(
            'multi-host launch detected (%d processes) but no per-process '
            'rank: the scheduler allocation carries no PMI rank variable. '
            'Launch through a process manager (srun/mpiexec/pbsdsh/'
            'blaunch) or pass --process_id explicitly.' % num)
    kwargs = {}
    if coord is not None:
        kwargs['coordinator_address'] = coord
    if num is not None:
        kwargs['num_processes'] = num
    if pid is not None:
        kwargs['process_id'] = pid
    if log is not None:
        log.info('multi-host init: %s', kwargs or 'JAX autodetect')
    # the flags/env provide the spec; with none of them JAX's own
    # cluster autodetection decides
    jax.distributed.initialize(**kwargs)
    return True
