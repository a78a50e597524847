"""K6, the denoiser's à-trous pass (csrc/atrous_kernel.cu), 4 a frame."""
PATTERN = r"\batrous_kernel\b"
HOOK = ("rtvb_tpu_torch.ops.denoise.atrous_kernel", "_atrous_cuda")

# per tap ≈ 39 flops, 24 taps and ≈ 15 for the centre (chip_smoke.py)
PIXEL_OPS = 24 * 39 + 15


def work(args, kwargs):
    """(bytes, ops): illum, var, depth, normal in (32 B), illum and var out
    (16 B) a pixel."""
    depth = args[2]
    n = depth.numel()
    return n * (32 + 16), PIXEL_OPS * n
