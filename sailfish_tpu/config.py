"""Flag/config system: argparse groups + rc-file overrides.

Counterpart of the reference's ``sailfish/config.py`` (LBConfig :17,
LBConfigParser.parse :59 with /etc/sailfishrc -> ~/.sailfishrc ->
./.sailfishrc chain, MachineSpec :94). This build keeps the same
override order: rc files -> class update_defaults -> script default_config
-> command line (reference controller.py:466-472).
"""

from __future__ import annotations

import argparse
import configparser
import os
import shlex


class LBConfig(argparse.Namespace):
    """Parsed simulation configuration.

    Derived convenience properties mirror reference config.py:27-29,83-89.
    """

    @property
    def output_required(self):
        return bool(self.output) or self.mode == 'visualization'

    @property
    def needs_iteration_num(self):
        return self.time_dependence or self.access_pattern == 'AA'

    @property
    def dtype(self):
        import jax.numpy as jnp
        return jnp.float64 if self.precision == 'double' else jnp.float32


class LBConfigParser:
    """argparse wrapper with option groups and rc files
    (reference config.py:32-92)."""

    RC_FILES = ['/etc/sailfishtpurc',
                os.path.expanduser('~/.sailfishtpurc'),
                '.sailfishtpurc']

    def __init__(self, description=None):
        self._parser = argparse.ArgumentParser(description=description)
        self._parser.add_argument('-q', '--quiet', action='store_true',
                                  default=False, help='reduce logging')
        self._parser.add_argument('-v', '--verbose', action='store_true',
                                  default=False)
        self._parser.add_argument('--silent', action='store_true',
                                  default=False)
        self.config = LBConfig()
        # internal, non-flag state
        self.config.time_dependence = False
        self.config.space_dependence = False
        self.config.unit_test = False

    def add_group(self, name):
        return self._parser.add_argument_group(name)

    def set_defaults(self, defaults):
        return self._parser.set_defaults(**defaults)

    def parse(self, args=None, internal_defaults=None):
        # rc files first (lowest priority beyond hard defaults)
        cp = configparser.ConfigParser()
        cp.read(self.RC_FILES)
        if cp.has_section('main'):
            rc = {}
            for key, val in cp.items('main'):
                for s, t in ((cp.getboolean, bool), (cp.getint, int),
                             (cp.getfloat, float)):
                    try:
                        rc[key] = s('main', key)
                        break
                    except ValueError:
                        continue
                else:
                    rc[key] = val
            self._parser.set_defaults(**rc)
        if internal_defaults:
            self._parser.set_defaults(**internal_defaults)
        env = os.environ.get('SAILFISH_TPU_FLAGS')
        if env and args is None:
            args = shlex.split(env)
        self._parser.parse_args(args=args, namespace=self.config)
        return self.config


class MachineSpec:
    """Declaration of a machine in a (historical) cluster layout
    (reference config.py:94-134). Retained for API compatibility; the
    runtime derives its topology from jax.devices() / jax.distributed
    instead of SSH host lists."""

    def __init__(self, host, addr, gpus=None, iface='eth0', **kwargs):
        self.host = host
        self.addr = addr
        self.gpus = gpus if gpus is not None else [0]
        self.iface = iface
        self.settings = kwargs

    def set_config(self, config):
        for opt, value in self.settings.items():
            setattr(config, opt, value)
