"""chip_smoke.py on the CPU: its numpy reference against StepBuilder, its
refusal of any platform but a GPU, and the form of its last line. The
script's device phases run only on a card."""
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_reference_lattice_matches_engine():
    """The script's own D3Q19 table is the engine's lattice, up to the
    order of directions."""
    from sailfish_tpu import lattice
    g = lattice.get_grid('D3Q19')
    order = chip_smoke.engine_order(g)
    assert sorted(order) == list(range(19))
    np.testing.assert_allclose(g.weights[order], chip_smoke.D3Q19_W)
    assert (chip_smoke.D3Q19_C[chip_smoke.D3Q19_OPP]
            == -chip_smoke.D3Q19_C).all()


@pytest.mark.parametrize('n,steps', [(12, 20), (16, 8)])
def test_reference_matches_step_builder(n, steps):
    errs = chip_smoke.compare_with_reference(n, steps)
    assert set(errs) == {'xla'}
    assert errs['xla'] < 1e-6, errs


def _run_script(cwd, env_extra):
    env = {k: v for k, v in os.environ.items() if k != 'XLA_FLAGS'}
    env.update(env_extra)
    return subprocess.run([sys.executable, 'chip_smoke.py'], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _assert_refused(res):
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_refuses_cpu_platform():
    """With no GPU the script fails before any phase: nvidia-smi is
    absent, or JAX's platform is not gpu."""
    _assert_refused(_run_script(REPO, {'JAX_PLATFORMS': 'cpu'}))
    devices = jax.devices()
    assert devices[0].platform == 'cpu'
    with pytest.raises(SystemExit, match="not 'gpu'"):
        chip_smoke.util.require_gpu(devices)


def test_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, 'chip_smoke.py'), tmp_path)
    _assert_refused(_run_script(tmp_path, {'JAX_PLATFORMS': 'cpu'}))


def test_result_line_form():
    class Dev:
        platform = 'gpu'
        device_kind = 'NVIDIA H100 80GB HBM3'

    line = chip_smoke.result_line([Dev()])
    assert json.loads(line) == {'ok': True, 'device': {
        'platform': 'gpu', 'kind': 'NVIDIA H100 80GB HBM3', 'count': 1}}
    assert '\n' not in line
    four = json.loads(chip_smoke.result_line([Dev()] * 4))
    assert four['device']['count'] == 4
