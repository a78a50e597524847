"""K2, rays against the triangle soup (csrc/tri_kernel.cu), 5 a frame."""
PATTERN = r"\btri_kernel\b"
HOOK = ("rtvb_tpu_torch.ops.triangles", "intersect_packed_cuda")


def pairs(o, d, tri, cap, chunk: int = 1 << 15) -> int:
    """The (ray, row) pairs whose segment [0, cap] meets the row's box,
    over the soup's rows that are not padding: the Möller–Trumbore tests
    these rays need at least."""
    import torch
    v0 = tri[:, 0:3]
    v1, v2 = v0 + tri[:, 3:6], v0 + tri[:, 6:9]
    live = (tri != 0).any(1)
    lo = torch.minimum(torch.minimum(v0, v1), v2)[live]
    hi = torch.maximum(torch.maximum(v0, v1), v2)[live]
    O = torch.stack([c.reshape(-1) for c in o], -1)
    D = torch.stack([c.reshape(-1) for c in d], -1)
    C = (torch.full((O.shape[0],), float("inf"), device=O.device)
         if cap is None else cap.reshape(-1))
    total = 0
    for s in range(0, O.shape[0], chunk):
        oo, dd = O[s:s + chunk, None, :], D[s:s + chunk, None, :]
        t1, t2 = (lo - oo) / dd, (hi - oo) / dd
        flat = dd == 0
        inside = (oo >= lo) & (oo <= hi)
        inf = torch.full_like(t1, float("inf"))
        tmin = torch.where(flat, torch.where(inside, -inf, inf),
                           torch.minimum(t1, t2))
        tmax = torch.where(flat, torch.where(inside, inf, -inf),
                           torch.maximum(t1, t2))
        near = torch.clamp(tmin.amax(-1), min=0.0)
        far = torch.minimum(tmax.amin(-1), C[s:s + chunk, None])
        total += int((near <= far).sum())
    return total


def work(args, kwargs):
    """(bytes, ops) of one launch: the rays (24 B) and their cap where the
    call passes one (4 B) in, the record out (17 B), the soup once;
    Möller–Trumbore's 27 flops for each (ray, row) pair the data needs."""
    from rtvbbench.roofline import nbytes
    o, d, tri = args[:3]
    cap = args[3] if len(args) > 3 else kwargs.get("t_cap")
    n_rays = o[0].numel()
    return (n_rays * (24 + 4 * (cap is not None) + 17) + nbytes(tri),
            27 * pairs(o, d, tri, cap))
