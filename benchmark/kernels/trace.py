"""K1, the voxel trace (csrc/trace_kernel.cu), 5 launches a frame."""
PATTERN = r"\btrace_kernel\b"
HOOK = ("rtvb_tpu_torch.ops.dda", "trace_cuda")

# K1's operations, counted from csrc/trace_kernel.cu (chip_smoke.py): a
# ray's set-up and epilogue, and one sub-step's unconditional path
SETUP_OPS = {False: 120, True: 70}
SUBSTEP_OPS = 96


def work(args, kwargs):
    """(bytes, ops) of one launch: the rays (24 B a ray), their cap where
    the call passes one (4 B), the record out (a 1-byte hit and the 4-byte
    t, and for closest hit the voxel, normal and material, 28 B more), the
    tables the instance reads; ops: the set-up per ray and the sub-steps
    these rays run, counted by the reference's plain march."""
    from reference.ops import dda
    from rtvbbench.roofline import nbytes
    o, d, tab, tp = args[:4]
    t_cap = args[4] if len(args) > 4 else kwargs.get("t_cap")
    any_hit = bool(args[5] if len(args) > 5 else kwargs.get("any_hit",
                                                             False))
    n_rays = o[0].numel()
    per = 24 + (4 if t_cap is not None else 0) + (5 if any_hit else 33)
    read = [tab.colmask, tab.df, tab.maxh]
    if not any_hit:
        read += [tab.schema, tab.exc_mask, tab.exc_key, tab.exc_id,
                 tab.block_to_mat]
    n_sub = dda.substeps(o, d, tab, tp, t_cap, any_hit)
    return (n_rays * per + nbytes(*read),
            SETUP_OPS[any_hit] * n_rays + SUBSTEP_OPS * n_sub)
