#!/usr/bin/env python
"""Live short-channel law-of-the-wall gate (device presubmit).

The full Re_tau=180 channel needs ~300k iterations to develop; its
stats live as a stored artifact validated by channel_loglaw.py. That
leaves no link between CURRENT code and turbulence physics, so this
gate runs a small TMS-wall channel for ~20k iterations from the
log-law initial profile and checks, loosely, that the mean profile is
still on the law and the wall friction balances: a regression in the
TMS wall math, the Guo forcing or the Reynolds accumulator moves the
profile far outside these bands within a few thousand steps (measured:
a disabled TMS reconstruction drifts the wall slope >40% by 10k).

About 550k nodes x 20k iterations: H = 23 gives a wall-normal extent
of 2H+2 = 48 (the TMS wall is wet with location 0.5, so the scene adds
one node per side) and the streamwise length is overridden to 256.
"""

import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..',
                                'examples', 'turbulence'))

KAPPA = 0.41
B = 5.5


def main(H=23, iters=20000, tol_mean=0.15, tol_fric=0.25):
    from channel_flow import ChannelSim, friction_velocity
    from sailfish_tpu.controller import LBSimulationController
    from sailfish_tpu.geo import LBGeometry3D
    from sailfish_tpu import util
    util.enable_compile_cache()

    ctrl = LBSimulationController(ChannelSim, LBGeometry3D,
                                  default_config=dict(
        H=H, wall='tms', Re_tau=180.0, max_iters=iters, every=iters,
        quiet=True, stats_every=20, streamwise=256))
    ctrl.run(ignore_cmdline=True)
    sim = ctrl._runner.sim
    stats = sim.reynolds_stats()
    assert stats is not None, 'Reynolds accumulator produced nothing'
    mean_w = stats['u'][0]    # streamwise = x, profiled along y
    w_sq = stats['u'][1]      # second raw moment of the streamwise u

    u_tau = friction_velocity(0.05, 180.0)
    visc = u_tau * H / 180.0
    nx = mean_w.shape[0]
    y = np.minimum(np.arange(nx), nx - 1 - np.arange(nx)) + 0.5
    yp = y * u_tau / visc
    up = mean_w / u_tau

    sel = (yp > 30) & (yp < 0.8 * 180.0) & (np.arange(nx) < nx // 2)
    loglaw = np.log(yp[sel]) / KAPPA + B
    err = np.abs(up[sel] - loglaw) / loglaw
    u_tau_wall = math.sqrt(max(visc * (mean_w[2] - mean_w[1]), 1e-12))

    print(f'live channel H={H} iters={iters}: log-law rel err mean '
          f'{err.mean():.3f} max {err.max():.3f}')
    print(f'u_tau wall-slope {u_tau_wall:.5f} vs nominal {u_tau:.5f} '
          f'({abs(u_tau_wall - u_tau) / u_tau:.1%})')
    assert np.all(np.isfinite(mean_w)), 'NaN in mean profile'
    assert err.mean() < tol_mean, 'mean profile off the log law'
    assert abs(u_tau_wall - u_tau) / u_tau < tol_fric, \
        'friction imbalance at the TMS wall'
    # fluctuations must neither vanish (dead accumulator) nor blow up
    wrms = np.sqrt(np.maximum(w_sq - mean_w ** 2, 0.0))
    core = wrms[nx // 4: nx // 2]
    assert 0.05 * u_tau < core.mean() < 6.0 * u_tau, \
        f'unphysical streamwise rms {core.mean() / u_tau:.2f} u_tau'
    print('ok')


if __name__ == '__main__':
    main(*(int(a) for a in sys.argv[1:3]))
