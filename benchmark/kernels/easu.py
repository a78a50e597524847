"""K7, the EASU upscale below render scale 1 (csrc/easu_kernel.cu), 1 a
frame at a rung."""
PATTERN = r"\beasu_kernel\b"
HOOK = ("rtvb_tpu_torch.ops.easu_kernel", "_easu_cuda")


def work(args, kwargs):
    """(bytes, ops): the (H, W, 3) f32 input read once, the (out_h, out_w,
    3) output written once; ≈ 25 flops per input texel and ≈ 390 per
    output pixel."""
    img, out_h, out_w = args[:3]
    H, W = img.shape[:2]
    return 12 * (H * W + out_h * out_w), 25 * H * W + 390 * out_h * out_w
