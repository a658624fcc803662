"""The PyTorch port's configs equal the JAX package's field for field, and
the port (with ``chip_smoke.py``) imports neither JAX nor any module of the
JAX package."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro import configs as jcfglib
from repro_torch import configs as tcfglib

ROOT = Path(__file__).resolve().parents[1]


def _fields(cfg):
    return {type(cfg).__name__: dataclasses.asdict(cfg)}


@pytest.mark.parametrize("arch", jcfglib.ARCHS)
@pytest.mark.parametrize("which", ["get_config", "get_smoke_config"])
def test_config_equals_jax(arch, which):
    j = getattr(jcfglib, which)(arch)
    t = getattr(tcfglib, which)(arch)
    assert type(t).__module__.startswith("repro_torch.")
    assert _fields(t) == _fields(j)


def test_registry_equals_jax():
    assert tcfglib.ARCHS == jcfglib.ARCHS
    assert tcfglib.ALIASES == jcfglib.ALIASES
    for alias in jcfglib.ALIASES:
        assert tcfglib.canonical(alias) == jcfglib.canonical(alias)


_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(" ", 1)
    assert int(n_modules) >= 25 and bad.strip() == "[]"
