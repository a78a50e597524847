"""The port never imports JAX: in a fresh interpreter, import every
rtvb_tpu_torch module, build a 32×32 Engine(device="cpu") and render one
frame (the frame catches lazy imports, such as a mesh loader reached only
while building the decoration soup), then check sys.modules."""
import os
import pkgutil
import subprocess
import sys

import rtvb_tpu_torch

_SCRIPT = r"""
import importlib, pkgutil, sys
import rtvb_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rtvb_tpu_torch.__path__,
                                               "rtvb_tpu_torch.")]
for n in names:
    importlib.import_module(n)
from rtvb_tpu_torch.render.renderer import Engine, slice_settings
eng = Engine(settings=slice_settings(32, 32), device="cpu")
out = eng.render_realtime()
assert out.shape == (32, 32, 3), out.shape
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
print("MODULES", len(names))
print("LEAKED", leaked)
"""


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True,
                         text=True, env=env, cwd=root, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "LEAKED []" in res.stdout, res.stdout
    n_modules = len(list(pkgutil.walk_packages(rtvb_tpu_torch.__path__,
                                               "rtvb_tpu_torch.")))
    assert n_modules >= 20
    assert f"MODULES {n_modules}" in res.stdout, res.stdout
