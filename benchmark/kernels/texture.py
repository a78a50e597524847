"""K3, the authored atlas's trilinear sample (csrc/texture_kernel.cu), 1
a frame."""
PATTERN = r"\btexture_kernel\b"
HOOK = ("rtvb_tpu_torch.assets.image_textures", "_sample_cuda")


def work(args, kwargs):
    """(bytes, ops): tid, u, v, level in and 6 channels out a pixel (the
    texels read depend on the data: not counted); 2 levels × 4 taps × 6
    channels of bilinear blends ≈ 100 flops a pixel."""
    u = args[3]
    n = u.numel()
    return n * (16 + 24), 100 * n
