"""The authored texture atlas and K3's plain version against the JAX
package: `load_atlas` bit-exact, and `sample_atlas` (whose CPU path is the
port of `_sample_ref`) to 1e-6 on an image with a ragged edge, tiles that
mix several textures (seams), untextured pixels and a lod field that sends
tiles to both the demand-tier and the resident-tail levels.

The JAX reference runs op by op (jax.disable_jit), so both sides round
every product separately.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvb_tpu.assets import image_textures as jit_
from rtvb_tpu_torch.assets import image_textures as pit

torch.set_num_threads(2)

TEX_DIR = os.path.join(os.path.dirname(__file__), "..", "data", "textures")
NAMES = ["grass", "brick", "stone"]


@pytest.fixture(scope="module")
def atlases():
    ja, jn = jit_.load_atlas(TEX_DIR, NAMES)
    pa, pn = pit.load_atlas(TEX_DIR, NAMES)
    assert tuple(jn) == tuple(pn) == tuple(NAMES)
    return ja, pa


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint32)


def test_load_atlas_bit_exact(atlases):
    ja, pa = atlases
    np.testing.assert_array_equal(pa.lo.numpy().view(np.uint32), _bits(ja.lo))
    np.testing.assert_array_equal(pa.hi.numpy().view(np.uint32), _bits(ja.hi))


def _inputs(seed, H=70, W=200):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    # bands of texture ids crossing tile borders + untextured patches
    tid = ((xx // 37 + yy // 23) % 4).astype(np.int32) - 1
    u = (xx * 0.013 + rng.uniform(0, 0.01, (H, W))).astype(np.float32) * 3.0
    v = (yy * 0.021 + rng.uniform(0, 0.01, (H, W))).astype(np.float32) * 2.0
    # lod: fine close-up on the left (levels 0-2), coarse on the right
    lod = (np.exp2(xx / W * 9.0) / 512.0 * rng.uniform(0.7, 1.3, (H, W))
           ).astype(np.float32)
    return tid, u, v, lod


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_atlas_matches_sample_ref(atlases, seed):
    ja, pa = atlases
    tid, u, v, lod = _inputs(seed)
    with jax.disable_jit():
        js = jit_.sample_atlas(ja, jnp.asarray(tid), jnp.asarray(u),
                               jnp.asarray(v), jnp.asarray(lod),
                               backend="xla")
    T = torch.from_numpy
    ps = pit.sample_atlas(pa, T(tid), T(u), T(v), T(lod))
    pairs = list(zip(js.rgb, ps.rgb)) + [(js.du, ps.du), (js.dv, ps.dv),
                                         (js.rough_mul, ps.rough_mul)]
    for a, b in pairs:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)
    # the tiling really mixes the demand and tail levels
    lvl = pit.level_from_lod(T(lod)).numpy()
    assert lvl.min() < 1.0 and lvl.max() > 4.0
