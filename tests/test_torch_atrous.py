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


# phi_normal that is not a power of two (the dev panel steps 64 to 80.0),
# and steps past 126, whose window passes a block's shared memory on the
# card (atrous_iterations ≥ 8): on a 40×300 image, to the same 1e-5
# relative as above: the normal weight is now torch.pow on the CPU against
# XLA's pow, each within an ulp or two, and a weight's relative error
# reaches the output scaled by the weight's share of the sum
@pytest.mark.parametrize("step", [1, 128, 256])
@pytest.mark.parametrize("phi_normal", [80.0, 3.0])
def test_atrous_matches_jax_any_phi_normal_and_step(step, phi_normal):
    illum, var, depth, normal, rough = _inputs(step + int(phi_normal),
                                               H=40, W=300)
    phis = (2.0, phi_normal, 0.05)
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


def test_pow_mode_follows_pow_weight_and_torch_pow():
    """The kernel's rule for phi_normal (ops/denoise/atrous_kernel.py
    `pow_mode`): squarings where pow_weight squares, torch.pow's special
    cases by the float or its float32 rounding, else powf."""
    from rtvb_tpu_torch.ops.denoise import atrous_kernel as A
    cases = {64.0: (A.POW_SQUARE, 6), 1.0: (A.POW_SQUARE, 0),
             2.0: (A.POW_SQUARE, 1), 2.0 + 1e-12: (A.POW_SQUARE, 1),
             80.0: (A.POW_POWF, 0), 3.0: (A.POW_CUBE, 0),
             0.5: (A.POW_SQRT, 0), 0.5 + 1e-12: (A.POW_POWF, 0),
             -0.5: (A.POW_RSQRT, 0), -1.0: (A.POW_RECIP, 0),
             -2.0: (A.POW_INV_SQUARE, 0), 0.0: (A.POW_ZERO, 0),
             float("nan"): (A.POW_POWF, 0), 2.0 ** 40: (A.POW_SQUARE, 40)}
    for e, want in cases.items():
        assert A.pow_mode(e) == want, e
