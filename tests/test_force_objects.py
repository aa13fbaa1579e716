"""Momentum-exchange force objects + tracers (counterparts of reference
lb_base.ForceObject / kernel_force_objects.mako and tracers.mako)."""
import sys

import pytest

import numpy as np

sys.path.insert(0, 'examples')


@pytest.mark.slow
def test_sphere_drag_and_tracers():
    from sphere_3d import SphereSimulation
    from sailfish_tpu.controller import LBSimulationController
    from sailfish_tpu.geo import LBGeometry3D
    from sailfish_tpu.models.base import ForceObject
    from sailfish_tpu.tracers import TracerParticles

    class FOSim(SphereSimulation):
        def __init__(self, config):
            super().__init__(config)
            diam = config.lat_ny / 3.0
            x0 = 2.0 * diam
            y0 = config.lat_ny / 2.0
            z0 = config.lat_nz / 2.0
            r = diam / 2.0 + 2
            self.add_force_object(ForceObject(
                (int(x0 - r), int(y0 - r), int(z0 - r)),
                (int(x0 + r), int(y0 + r), int(z0 + r))))

    ctrl = LBSimulationController(FOSim, LBGeometry3D, default_config=dict(
        lat_nx=48, lat_ny=24, lat_nz=24, visc=0.05, max_iters=400,
        every=400, quiet=True))
    ctrl.run(ignore_cmdline=True)
    r = ctrl._runner
    r.update_force_objects()
    F = r.sim.force_objects[0].force()
    # drag along the flow (+x), lift negligible by symmetry
    assert F[0] > 0
    assert abs(F[1]) < 0.2 * F[0]
    assert abs(F[2]) < 0.2 * F[0]

    tp = TracerParticles(np.array([[5.0], [12.0], [12.0]]), (24, 24, 48))
    x0 = float(tp.to_numpy()[0, 0])
    for _ in range(5):
        tp.update(r)
    assert float(tp.to_numpy()[0, 0]) > x0
