"""Runner plumbing that stays with the single XLA engine: the
force-object window shift, the absence of TPU kernel modules, and the
persistent compile cache location."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sailfish_tpu import util
from sailfish_tpu.runner import window_shifted

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('window,shift', [
    ((slice(2, 6), slice(1, 5)), (1, -1)),        # interior
    ((slice(0, 4), slice(5, 8)), (2, -3)),        # wraps low and high
    ((slice(0, 8), slice(0, 8), slice(3, 5)), (-1, 0, 4)),  # 3D, full axes
])
def test_window_shifted_matches_roll(window, shift):
    shape = (8, 8, 8)[:len(window)]
    plane = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    got = np.asarray(window_shifted(jnp.asarray(plane), window, shift))
    want = np.roll(plane, shift, axis=tuple(range(len(shape))))[window]
    np.testing.assert_array_equal(got, want)


def test_package_has_no_tpu_kernels():
    for root, _, files in os.walk(os.path.join(REPO, 'sailfish_tpu')):
        for fn in files:
            if fn.endswith('.py'):
                with open(os.path.join(root, fn)) as f:
                    text = f.read()
                assert 'pallas.tpu' not in text and 'pltpu' not in text, fn


def test_runner_never_imports_pallas_tpu():
    code = ('import sys; sys.path.insert(0, "examples"); '
            'from ldc_3d import LDCSim; '
            'from sailfish_tpu.controller import LBSimulationController; '
            'c = LBSimulationController(LDCSim, default_config=dict('
            'lat_nx=8, lat_ny=8, lat_nz=8, max_iters=2, quiet=True)); '
            'c.run(ignore_cmdline=True); '
            'print(sorted(m for m in sys.modules '
            'if m.startswith("jax.experimental.pallas")))')
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert 'jax.experimental.pallas.tpu' not in res.stdout
    assert res.stdout.strip().endswith(']')


def test_compile_cache_dir_from_env(monkeypatch, tmp_path):
    """Where JAX_COMPILATION_CACHE_DIR is set it is the cache, and nothing
    in JAX's config is changed (JAX reads the variable itself)."""
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
    calls = []
    monkeypatch.setattr(jax.config, 'update',
                        lambda *a: calls.append(a))
    assert util.compile_cache_dir() == str(tmp_path)
    assert util.enable_compile_cache() == str(tmp_path)
    assert calls == []


@pytest.mark.parametrize('backend,cached', [('gpu', True), ('cpu', False)])
def test_compile_cache_default_is_fixed_in_checkout(monkeypatch, backend,
                                                    cached):
    """Without the variable, GPU programs are cached in .jax_cache/ of the
    checkout and CPU programs are not cached."""
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    assert util.compile_cache_dir() == os.path.join(REPO, '.jax_cache')
    calls = []
    monkeypatch.setattr(jax.config, 'update',
                        lambda *a: calls.append(a))
    monkeypatch.setattr(jax, 'default_backend', lambda: backend)
    got = util.enable_compile_cache()
    if cached:
        assert got == os.path.join(REPO, '.jax_cache')
        assert ('jax_compilation_cache_dir', got) in calls
        assert os.path.isdir(got)
    else:
        assert got is None and calls == []


def test_compile_cache_dir_is_ignored_by_git():
    with open(os.path.join(REPO, '.gitignore')) as f:
        assert '.jax_cache/' in f.read().split()
