"""À-trous pass dispatch (port of rtvb_tpu/ops/denoise/atrous_kernel.py).

CUDA tensors launch ``csrc/atrous_kernel.cu`` (K6): 32×8-pixel blocks that
stage their stencil window (rows of one residue class mod the step, 32
consecutive columns with a 2·step halo, or past a block's shared memory 32
columns of one residue class too) in shared memory, edge-clamped, at any
step and any phi_normal (so no fallback pass), with the same weight
formulas op for op as `passes.atrous_pass_plain`, which CPU tensors run.
"""
from __future__ import annotations

import torch

from ... import kernels as K
from .passes import atrous_pass_plain

ATROUS = K.register(K.CudaKernel("atrous", "rtvb_atrous_pow",
                                 [K.P] * 4 + [K.I] * 3 + [K.F] * 3
                                 + [K.I] * 2 + [K.P] * 2))

# csrc/atrous_kernel.cu PowMode
(POW_SQUARE, POW_ZERO, POW_SQRT, POW_RSQRT, POW_RECIP, POW_CUBE,
 POW_INV_SQUARE, POW_POWF) = range(8)


def pow_mode(phi_normal: float):
    """(mode, squarings) of `mathutil.pow_weight(x, phi_normal)` on a CUDA
    tensor: repeated squaring for a positive power-of-two integer; else
    torch.pow(x, e)'s CUDA rule, which tests 0, 0.5, -0.5 and -1 on the
    float itself and 2, 3 and -2 on it rounded to float32, and otherwise
    calls powf."""
    e = float(phi_normal)
    n = int(e) if abs(e) < 2.0 ** 62 else 0
    if float(n) == e and n > 0 and n & (n - 1) == 0:
        return POW_SQUARE, n.bit_length() - 1
    special = {0.0: POW_ZERO, 0.5: POW_SQRT, -0.5: POW_RSQRT,
               -1.0: POW_RECIP}
    if e in special:
        return special[e], 0
    e32 = float(torch.tensor(e, dtype=torch.float32))
    return {2.0: (POW_SQUARE, 1), 3.0: (POW_CUBE, 0),
            -2.0: (POW_INV_SQUARE, 0)}.get(e32, (POW_POWF, 0))


def _atrous_cuda(illum, var, depth, normal, step, phi_lum, phi_normal,
                 phi_depth):
    H, W = depth.shape
    dev = depth.device
    args = [K.as_input("illum", illum, torch.float32, (H, W, 3), dev),
            K.as_input("var", var, torch.float32, (H, W), dev),
            K.as_input("depth", depth, torch.float32, (H, W), dev),
            K.as_input("normal", normal, torch.float32, (H, W, 3), dev)]
    mode, n_sq = pow_mode(phi_normal)
    out = torch.empty((H, W, 3), dtype=torch.float32, device=dev)
    out_var = torch.empty((H, W), dtype=torch.float32, device=dev)
    ATROUS.launch(dev, *args, H, W, int(step), float(phi_lum),
                  float(phi_depth), float(phi_normal), mode, n_sq, out,
                  out_var)
    return out, out_var


def atrous_pass(illum, var, depth, normal, step: int, phi_lum: float,
                phi_normal: float, phi_depth: float):
    """One edge-stopping 5×5 à-trous pass at `step` → (illum, var)."""
    if K.on_cuda(depth):
        return _atrous_cuda(illum, var, depth, normal, step, phi_lum,
                            phi_normal, phi_depth)
    return atrous_pass_plain(illum, var, depth, normal, step, phi_lum,
                             phi_normal, phi_depth)
