#!/usr/bin/env python
"""Headline benchmark: D3Q19 BGK lid-driven cavity, 256^3, fp32, one GPU.

Prints the card's name and power limit, then ONE JSON line:
{"metric", "value", "unit", "spread", "device"}. The value is the median
MLUPS of three repeats of the runner's jitted loop, each timed on the host
clock around ``jax.block_until_ready``. Refuses any platform but ``gpu``.
"""

import json
import sys
import time


def main():
    import jax

    from sailfish_tpu import util
    util.enable_compile_cache()
    cards = util.gpu_cards()
    devices = jax.devices()
    util.require_gpu(devices)
    from examples.ldc_3d import LDCSim
    from sailfish_tpu.controller import LBSimulationController

    n = 256
    warmup = 20
    iters = 1000

    ctrl = LBSimulationController(LDCSim, default_config={
        'lat_nx': n, 'lat_ny': n, 'lat_nz': n,
        'max_iters': 0, 'quiet': True})
    ctrl.run(ignore_cmdline=True)
    runner = ctrl._runner

    f = runner._run_steps(runner.f, warmup)
    jax.block_until_ready(f)
    samples = []
    for _ in range(3):
        t0 = time.perf_counter()
        f = runner._run_steps(f, iters)
        jax.block_until_ready(f)
        samples.append(n ** 3 * iters / (time.perf_counter() - t0)
                       / 1e6)
    samples.sort()
    print(cards[0])
    print(json.dumps({
        'metric': 'MLUPS D3Q19 LDC 256^3 fp32, one card',
        'value': samples[1],
        'unit': 'MLUPS',
        'spread': samples,
        'device': {'platform': devices[0].platform,
                   'kind': devices[0].device_kind,
                   'card': cards[0]},
    }))
    return 0


if __name__ == '__main__':
    sys.exit(main())
