"""À-trous pass dispatch (port of rtvb_tpu/ops/denoise/atrous_kernel.py).

CUDA tensors launch ``csrc/atrous_kernel.cu`` (K6): 32×8-pixel blocks that
stage their stencil window (rows of one residue class mod the step, 32
consecutive columns with a 2·step halo) in shared memory, edge-clamped, at
any step up to 126 on an H100 (so no fallback pass; a wider step's window
passes a block's shared memory and the launch raises), with the same
weight formulas op for op as `passes.atrous_pass_plain`, which CPU tensors
run.
"""
from __future__ import annotations

import torch

from ... import kernels as K
from .passes import atrous_pass_plain

ATROUS = K.register(K.CudaKernel("atrous", "rtvb_atrous",
                                 [K.P] * 4 + [K.I] * 3 + [K.F] * 2
                                 + [K.I] + [K.P] * 2))


def _atrous_cuda(illum, var, depth, normal, step, phi_lum, phi_normal,
                 phi_depth):
    H, W = depth.shape
    dev = depth.device
    args = [K.as_input("illum", illum, torch.float32, (H, W, 3), dev),
            K.as_input("var", var, torch.float32, (H, W), dev),
            K.as_input("depth", depth, torch.float32, (H, W), dev),
            K.as_input("normal", normal, torch.float32, (H, W, 3), dev)]
    n_pow = int(phi_normal)
    if float(n_pow) != float(phi_normal) or n_pow <= 0 or n_pow & (n_pow - 1):
        raise ValueError("the à-trous kernel takes a power-of-two phi_normal")
    out = torch.empty((H, W, 3), dtype=torch.float32, device=dev)
    out_var = torch.empty((H, W), dtype=torch.float32, device=dev)
    ATROUS.launch(dev, *args, H, W, int(step), float(phi_lum),
                  float(phi_depth), n_pow, out, out_var)
    return out, out_var


def atrous_pass(illum, var, depth, normal, step: int, phi_lum: float,
                phi_normal: float, phi_depth: float):
    """One edge-stopping 5×5 à-trous pass at `step` → (illum, var)."""
    if K.on_cuda(depth):
        return _atrous_cuda(illum, var, depth, normal, step, phi_lum,
                            phi_normal, phi_depth)
    return atrous_pass_plain(illum, var, depth, normal, step, phi_lum,
                             phi_normal, phi_depth)
