"""ablate_pt's notex variant against the JAX package's render_frame with
the JAX tool's own patch of its procedural textures
(`textures.sample_scale` → ones, `sample_normal_delta` → zeros, as
tools/ablate_pt.py rebinds them), applied while JAX traces and restored
after: the harness and bars of tests/test_torch_tools_jax.py, in a file
of its own so that its JAX compile (≈ 100 s cold) runs beside the
others."""
import contextlib

import jax.numpy as jnp

from rtvb_tpu.assets import textures as jtextures
from test_torch_tools_jax import variant_matches_jax


@contextlib.contextmanager
def jax_notex():
    saved = (jtextures.sample_scale, jtextures.sample_normal_delta)
    jtextures.sample_scale = lambda tid, u, v, lod=None: jnp.ones_like(u)
    jtextures.sample_normal_delta = \
        lambda tid, u, v, lod=None: (jnp.zeros_like(u), jnp.zeros_like(u))
    try:
        yield
    finally:
        jtextures.sample_scale, jtextures.sample_normal_delta = saved


def test_ablate_notex_matches_jax():
    originals = (jtextures.sample_scale, jtextures.sample_normal_delta)
    variant_matches_jax("notex", jax_notex())
    assert (jtextures.sample_scale, jtextures.sample_normal_delta) == \
        originals
