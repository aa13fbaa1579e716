from setuptools import find_packages, setup

setup(
    name='sailfish_tpu',
    version='0.1.0',
    description='JAX lattice-Boltzmann CFD framework '
                '(JAX/XLA rebuild of the Sailfish scene API)',
    packages=find_packages(include=['sailfish_tpu', 'sailfish_tpu.*']),
    python_requires='>=3.10',
)
