"""Multi-host bootstrap hook (jax.distributed.initialize path; the
analog of the reference's execnet/PBS/LSF cluster startup,
controller.py:496-658, util.py:92-128)."""
import numpy as np

from sailfish_tpu import util


def test_slurm_env_autodetect(monkeypatch):
    monkeypatch.setenv('SLURM_PROCID', '3')
    monkeypatch.setenv('SLURM_NTASKS', '16')
    monkeypatch.setenv('SLURM_STEP_NODELIST', 'gpu-host[0-3],gpu-extra')
    coord, num, pid = util.cluster_env_spec()
    assert coord == 'gpu-host0:8476'
    assert num == 16 and pid == 3


def test_ompi_env_autodetect(monkeypatch):
    for k in ('SLURM_PROCID', 'SLURM_NTASKS'):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv('OMPI_COMM_WORLD_SIZE', '4')
    monkeypatch.setenv('OMPI_COMM_WORLD_RANK', '2')
    coord, num, pid = util.cluster_env_spec()
    assert coord is None and num == 4 and pid == 2


def test_pbs_nodefile_autodetect(monkeypatch, tmp_path):
    for k in ('SLURM_PROCID', 'SLURM_NTASKS', 'OMPI_COMM_WORLD_SIZE'):
        monkeypatch.delenv(k, raising=False)
    nf = tmp_path / 'nodes'
    nf.write_text('nodeA\nnodeB\nnodeC\n')
    monkeypatch.setenv('PBS_NODEFILE', str(nf))
    monkeypatch.setenv('PBS_TASKNUM', '1')
    coord, num, pid = util.cluster_env_spec()
    assert coord == 'nodeA:8476' and num == 3 and pid == 1


def test_lsf_blaunch_autodetect(monkeypatch):
    for k in ('SLURM_PROCID', 'SLURM_NTASKS', 'OMPI_COMM_WORLD_SIZE',
              'PBS_NODEFILE'):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv('LSB_HOSTS', 'nodeA nodeA nodeB nodeB')
    monkeypatch.setenv('LSF_PM_TASKID', '3')  # blaunch ranks are 1-based
    coord, num, pid = util.cluster_env_spec()
    assert coord == 'nodeA:8476' and num == 4 and pid == 2


def test_pbs_pmi_rank_fallback(monkeypatch, tmp_path):
    """Without pbsdsh vars the PMI layer supplies the rank."""
    for k in ('SLURM_PROCID', 'SLURM_NTASKS', 'OMPI_COMM_WORLD_SIZE',
              'PBS_TASKNUM', 'PBS_VNODENUM'):
        monkeypatch.delenv(k, raising=False)
    nf = tmp_path / 'nodes'
    nf.write_text('nodeA\nnodeB\n')
    monkeypatch.setenv('PBS_NODEFILE', str(nf))
    monkeypatch.setenv('PMIX_RANK', '1')
    coord, num, pid = util.cluster_env_spec()
    assert coord == 'nodeA:8476' and num == 2 and pid == 1


def test_init_distributed_missing_rank_raises(monkeypatch, tmp_path):
    """A multi-process allocation without any per-process rank must fail
    loudly, not initialize every process as rank 0."""
    import pytest
    for k in ('SLURM_PROCID', 'SLURM_NTASKS', 'OMPI_COMM_WORLD_SIZE',
              'PBS_TASKNUM', 'PBS_VNODENUM', 'PMIX_RANK', 'PMI_RANK'):
        monkeypatch.delenv(k, raising=False)
    nf = tmp_path / 'nodes'
    nf.write_text('nodeA\nnodeB\n')
    monkeypatch.setenv('PBS_NODEFILE', str(nf))

    class Cfg:
        coordinator_address = ''
        num_processes = 0
        process_id = -1

    with pytest.raises(RuntimeError, match='no per-process rank'):
        util.init_distributed(Cfg())


def test_init_distributed_flag_override(monkeypatch):
    """Explicit flags win over env; the hook passes them to
    jax.distributed.initialize."""
    import jax
    calls = {}

    def fake_init(**kw):
        calls.update(kw)

    monkeypatch.setattr(jax.distributed, 'initialize', fake_init)
    monkeypatch.setenv('SLURM_PROCID', '9')
    monkeypatch.setenv('SLURM_NTASKS', '99')

    class Cfg:
        coordinator_address = 'head:1234'
        num_processes = 8
        process_id = 5

    assert util.init_distributed(Cfg())
    assert calls == {'coordinator_address': 'head:1234',
                     'num_processes': 8, 'process_id': 5}


def test_cluster_flag_through_controller(monkeypatch):
    """--cluster wires init_distributed into controller startup."""
    import jax
    called = {}
    monkeypatch.setattr(jax.distributed, 'initialize',
                        lambda **kw: called.update(kw or {'auto': True}))

    from sailfish_tpu.controller import LBSimulationController
    from sailfish_tpu.models.single import LBFluidSim
    from sailfish_tpu.subdomain import Subdomain2D

    class Dom(Subdomain2D):
        def initial_conditions(self, sim, hx, hy):
            sim.rho[:] = 1.0

    class Sim(LBFluidSim):
        subdomain = Dom

    ctrl = LBSimulationController(Sim, default_config=dict(
        lat_nx=16, lat_ny=16, max_iters=2, every=2, quiet=True,
        periodic_x=True, periodic_y=True, cluster=True,
        coordinator_address='head:1234', num_processes=1,
        process_id=0))
    ctrl.run(ignore_cmdline=True)
    assert called.get('coordinator_address') == 'head:1234'
