"""sailfish_tpu: a JAX lattice-Boltzmann CFD framework.

A ground-up JAX/XLA rebuild with the scene/state API of
sailfish-team/sailfish: LBSim
subclasses + Subdomain geometry + node_type boundary conditions drive a
fused collide-and-propagate step over (optionally mesh-sharded) device
arrays instead of runtime-generated CUDA kernels.
"""

__version__ = '0.1.0'
