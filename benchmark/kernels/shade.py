"""K4, the fused RIS / ReSTIR / BSDF shade (csrc/shade_kernel.cu), 3 a
frame."""
PATTERN = r"\b(shade_kernel|fill_ptr_table)\b"   # K4 and its pointer table
HOOK = ("rtvb_tpu_torch.render.ris_kernel", "fused_shade_cuda")


def work(args, kwargs):
    """(bytes, ops): every input plane read once, the output planes written
    once, the tables; ops ≈ 100 flops per RIS candidate, 120 per tap, 450
    for the winner's shading and the BSDF sample."""
    from reference.render import ris_kernel as RK
    from rtvbbench.roofline import nbytes
    cfg = args[0]
    H, W = args[8][0].shape
    n_in = 15 + (1 + 9 * cfg.n_taps if cfg.n_taps else 0) \
        + (4 if cfg.blue_noise else 0)
    tables = nbytes(*args[3:8])
    flops = 100 * (cfg.n_local + 2) + 120 * cfg.n_taps + 450
    return H * W * 4 * (n_in + RK.N_OUT) + tables, flops * H * W
