"""The port's own copies of the JAX package's jax-free modules (settings,
scene, block registry, decoration meshes, PNG reading) hold the same
values as the originals."""
import dataclasses
import os

import numpy as np
import pytest

from rtvb_tpu.assets import blocks as jblocks
from rtvb_tpu.assets import decorations as jdeco
from rtvb_tpu.core import config as jconfig
from rtvb_tpu.core import scene as jscene
from rtvb_tpu.utils import image as jimage
from rtvb_tpu_torch.assets import blocks as pblocks
from rtvb_tpu_torch.assets import decorations as pdeco
from rtvb_tpu_torch.core import config as pconfig
from rtvb_tpu_torch.core import scene as pscene
from rtvb_tpu_torch.utils import image as pimage

ROOT = os.path.join(os.path.dirname(__file__), "..")
ASSETS = os.path.join(ROOT, "data", "assets")


def test_settings_equal():
    js, ps = jconfig.Settings(), pconfig.Settings()
    assert [f.name for f in dataclasses.fields(ps)] == \
        [f.name for f in dataclasses.fields(js)]
    for f in dataclasses.fields(js):
        assert dataclasses.asdict(getattr(ps, f.name)) == \
            dataclasses.asdict(getattr(js, f.name)), f.name
    assert ps.to_dict() == js.to_dict()
    assert ps.rendering.fused_shading and ps.rendering.render_scale == 1.0


def test_scene_config_equal():
    assert dataclasses.asdict(pscene.SceneConfig()) == \
        dataclasses.asdict(jscene.SceneConfig())


@pytest.mark.parametrize("source", ["builtin", "yaml"])
def test_block_registry_equal(source):
    if source == "builtin":
        jr, pr = jblocks.BlockRegistry.builtin(), \
            pblocks.BlockRegistry.builtin()
    else:
        path = os.path.join(ASSETS, "blocks.yaml")
        jr, pr = jblocks.BlockRegistry.from_yaml(path), \
            pblocks.BlockRegistry.from_yaml(path)
    assert [(b.id, b.name) for b in pr.blocks] == \
        [(b.id, b.name) for b in jr.blocks]
    for jb, pb in zip(jr.blocks, pr.blocks):
        assert dataclasses.asdict(pb) == dataclasses.asdict(jb), jb.name
    assert pr.emissive_ids == jr.emissive_ids
    for name in ("lantern", "torch", "brick", "grass"):
        assert pr.id_of(name) == jr.id_of(name)


def test_decoration_meshes_equal():
    assert sorted(pdeco.PROCEDURAL_MESHES) == sorted(jdeco.PROCEDURAL_MESHES)
    for name, fn in jdeco.PROCEDURAL_MESHES.items():
        for a, b in zip(fn(), pdeco.PROCEDURAL_MESHES[name]()):
            np.testing.assert_array_equal(b, a, err_msg=name)
    assert pdeco.registry().entries == jdeco.registry().entries


@pytest.mark.parametrize("name", ["character_albedo", "grass_n"])
def test_read_png_equal(name):
    path = os.path.join(ROOT, "data", "textures", f"{name}.png")
    np.testing.assert_array_equal(pimage.read_png(path),
                                  jimage.read_png(path))
