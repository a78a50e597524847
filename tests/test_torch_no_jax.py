"""The port never imports JAX nor the JAX package `rtvb_tpu`: in a fresh
interpreter, import every rtvb_tpu_torch module, build a 32×32
Engine(device="cpu") with the shipped settings and render one frame at
native resolution, one at the 1/2 rung (EASU) and one with a walking
character, and run the offline app for 2 frames at 32×32 on the CPU (the
frames catch lazy imports, such as the model loader reached only while
building the soup or the character, or the PNG writer's native binding),
then check sys.modules.  A scan of the sources catches import lines on
paths the frame does not reach."""
import os
import pkgutil
import re
import subprocess
import sys

import pytest

import rtvb_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys
import rtvb_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rtvb_tpu_torch.__path__,
                                               "rtvb_tpu_torch.")]
for n in names:
    importlib.import_module(n)
from rtvb_tpu_torch.render.renderer import Engine
eng = Engine(width=32, height=32, device="cpu")     # the shipped Settings()
assert eng.settings.rendering.fused_shading
out = eng.render_realtime()
assert out.shape == (32, 32, 3), out.shape
eng.set_render_scale(0.5)                  # the 1/2 rung: EASU upscale
assert (eng.width, eng.height) == (16, 16)
out = eng.render_realtime()
assert out.shape == (32, 32, 3), out.shape
from rtvb_tpu_torch.models.character import Character
ch = Character(cfg_world=eng.cfg)           # loads data/models/character.glb
eng.add_entity(ch.entity)
ch.update(eng.host_world, 1.0 / 30.0, (1.0, 0.0))
out = eng.render_realtime()                 # the walking character's frame
assert eng.entity_buffers().tri_packed.shape == (128, 9)
import os, tempfile
from rtvb_tpu_torch.apps import offline      # the offline app's whole path
with tempfile.TemporaryDirectory() as td:
    rc = offline.main(["--width", "32", "--height", "32", "--frames", "2",
                       "--device", "cpu", "--out-dir", td])
    assert rc == 0 and sorted(os.listdir(td)) == ["frame_0001.png",
                                                  "frame_0002.png"]
for mod in ("apps.interactive", "apps.offline", "core.controllers",
            "ui.font", "ui.raster", "ui.overlay", "world.persistence",
            "utils.perf", "utils.image", "utils.image_diff", "utils.native"):
    assert "rtvb_tpu_torch." + mod in sys.modules, mod
leaked = sorted(m for m in sys.modules
                if m in ("jax", "rtvb_tpu") or m.startswith(("jax.",
                                                             "rtvb_tpu.")))
print("MODULES", len(names))
print("LEAKED", leaked)
"""

# `import rtvb_tpu`, `import rtvb_tpu.x`, `from rtvb_tpu import`,
# `from rtvb_tpu.x import` — but not rtvb_tpu_torch
_JAX_PKG_IMPORT = re.compile(
    r"^\s*(import|from)\s+rtvb_tpu(\.|\s|$)", re.MULTILINE)


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "LEAKED []" in res.stdout, res.stdout
    n_modules = len(list(pkgutil.walk_packages(rtvb_tpu_torch.__path__,
                                               "rtvb_tpu_torch.")))
    assert n_modules >= 20
    assert f"MODULES {n_modules}" in res.stdout, res.stdout


def _port_sources():
    pkg = os.path.join(ROOT, "rtvb_tpu_torch")
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "kernel_ab.py")]
    for d, _, files in os.walk(pkg):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_port_sources_import_no_jax_package():
    srcs = _port_sources()
    assert len(srcs) >= 20
    bad = []
    for path in srcs:
        with open(path) as f:
            text = f.read()
        for mt in _JAX_PKG_IMPORT.finditer(text):
            line = text[mt.start():text.index("\n", mt.start())]
            bad.append(f"{os.path.relpath(path, ROOT)}: {line.strip()}")
        if re.search(r"^\s*(import|from)\s+jax\b", text, re.MULTILINE):
            bad.append(f"{os.path.relpath(path, ROOT)}: imports jax")
    assert not bad, bad


@pytest.mark.parametrize("line,hit", [
    ("from rtvb_tpu.core.config import Settings", True),
    ("    from rtvb_tpu.utils.image import read_png", True),
    ("import rtvb_tpu", True),
    ("from rtvb_tpu import render", True),
    ("from rtvb_tpu_torch.render import sky", False),
    ("import rtvb_tpu_torch.kernels", False),
    ("from ..core.config import Settings", False),
])
def test_import_scan_pattern(line, hit):
    assert bool(_JAX_PKG_IMPORT.search(line)) == hit
