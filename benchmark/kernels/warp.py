"""K5, the ReSTIR and denoiser history warps (csrc/warp_kernel.cu), 2 a
frame."""
PATTERN = r"\bwarp_(nearest|bilinear)_kernel\b"
HOOK = ("rtvb_tpu_torch.ops.warp_kernel", "_warp_cuda")


def work(args, kwargs):
    """(bytes, ops): the source coordinates (8 B a pixel), C planes in, C
    planes (C + pairs, bilinear) out, the 1-byte valid mask; 4 ops a pixel
    nearest, 8 a channel bilinear."""
    hist, sy, sx, bilinear, pairs = args[:5]
    C = hist.shape[0]
    n = sy.numel()
    n_out = C + (pairs if bilinear else 0)
    ops = 8 * n_out * n if bilinear else 4 * n
    return n * (8 + 4 * C + 4 * n_out + 1), ops
