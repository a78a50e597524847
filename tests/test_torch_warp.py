"""K5's plain versions (rtvb_tpu_torch.ops.warp_kernel, run by the wrapper
on CPU tensors) against the JAX package's twins `warp_nearest_ref` /
`warp_bilinear_ref`: nearest bitwise on bit-carrying planes (NaN
patterns included) with `valid` equal, bilinear to 1e-6 with 6 bf16-pair
channels.  The JAX reference runs op by op (jax.disable_jit)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvb_tpu.ops import warp_kernel as jwk
from rtvb_tpu_torch.ops import warp_kernel as pwk
from rtvb_tpu_torch.ops.pack import pack2

torch.set_num_threads(2)


def _field(H, W, seed, amp):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    sy = yy + amp * np.sin(xx / 13.0) + rng.normal(0, 0.4, (H, W))
    sx = xx + amp * np.cos(yy / 9.0) + rng.normal(0, 0.4, (H, W))
    return sy.astype(np.float32), sx.astype(np.float32)


@pytest.mark.parametrize("amp", [1.5, 9.0])
def test_nearest_bitwise(amp):
    H, W = 36, 52
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2 ** 32, (8, H, W), dtype=np.uint64).astype(
        np.uint32)
    bits[0, :4, :4] = 0x7FC00001           # NaN payloads must survive
    bits[1, 4:8, :4] = 0xFFFFFFFF
    hist = bits.view(np.float32)
    sy, sx = _field(H, W, 2, amp)
    with jax.disable_jit():
        jo, jv = jwk.warp_nearest_ref(jnp.asarray(hist), jnp.asarray(sy),
                                      jnp.asarray(sx))
    po, pv = pwk.warp_nearest(torch.from_numpy(hist), torch.from_numpy(sy),
                              torch.from_numpy(sx))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(po.numpy().view(np.uint32),
                                  np.asarray(jo).view(np.uint32))
    assert 0.5 < pv.numpy().mean() < 1.0


@pytest.mark.parametrize("amp", [1.5, 9.0])
def test_bilinear_pairs(amp):
    H, W = 36, 52
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(13, H, W)).astype(np.float32)
    planes = [pack2(torch.from_numpy(vals[2 * c]),
                    torch.from_numpy(vals[2 * c + 1])).numpy()
              for c in range(6)] + [vals[12]]
    hist = np.stack(planes)
    sy, sx = _field(H, W, 4, amp)
    with jax.disable_jit():
        jo, jv = jwk.warp_bilinear_ref(jnp.asarray(hist), jnp.asarray(sy),
                                       jnp.asarray(sx), pair_channels=6)
    po, pv = pwk.warp_bilinear(torch.from_numpy(hist), torch.from_numpy(sy),
                               torch.from_numpy(sx), pair_channels=6)
    assert po.shape == (13, H, W)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-6)
