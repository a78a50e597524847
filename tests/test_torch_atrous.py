"""K6's plain version (rtvb_tpu_torch.ops.denoise: `atrous_pass` on CPU
tensors) against the JAX package's `passes.atrous_pass` at steps 1-16,
to 1e-5 relative.  The JAX reference runs op by op (jax.disable_jit)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvb_tpu.ops.denoise import passes as jpasses
from rtvb_tpu_torch.ops.denoise.atrous_kernel import atrous_pass

torch.set_num_threads(2)


def _inputs(seed, H=40, W=56):
    rng = np.random.default_rng(seed)
    illum = rng.gamma(2.0, 0.5, (H, W, 3)).astype(np.float32)
    var = rng.gamma(1.0, 0.05, (H, W)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = (10 + 0.2 * xx + 3 * (yy > H / 2)).astype(np.float32)
    depth[:5, :7] = 1e30                                  # sky pixels
    n = rng.normal(size=(H, W, 3)).astype(np.float32) * 0.15
    n[..., 1] += 1.0
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    rough = rng.uniform(0.2, 1.0, (H, W)).astype(np.float32)
    return illum, var, depth, n.astype(np.float32), rough


@pytest.mark.parametrize("step", [1, 2, 4, 8, 16])
def test_atrous_matches_jax(step):
    illum, var, depth, normal, rough = _inputs(step)
    phis = (2.0, 64.0, 0.05)
    with jax.disable_jit():
        ji, jv = jpasses.atrous_pass(jnp.asarray(illum), jnp.asarray(var),
                                     jnp.asarray(depth), jnp.asarray(normal),
                                     jnp.asarray(rough), step, *phis)
    T = torch.from_numpy
    pi, pv = atrous_pass(T(illum), T(var), T(depth), T(normal), step, *phis)
    np.testing.assert_allclose(pi.numpy(), np.asarray(ji), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-7)
