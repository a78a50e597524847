"""The hand-written CUDA kernels against their plain PyTorch versions on the
card (marker `gpu`; skipped where torch sees no CUDA device).  Run on a
GPU machine with:  python -m pytest tests/test_torch_gpu.py -m gpu

Small shapes with ragged edges; K1, K2, K3, K4 and K5 bit-exact (the
library is built with --fmad=false, so every product rounds like the plain
version's), K6 to 1e-5 relative; K1 also at the frame's ray-wave shapes,
on ray counts that fill no whole 32-ray chunk and on an empty ray set;
K6 also at every step 1-16, 24 and 32 on a 1080p G-buffer, on an image
smaller than one tile and on an odd size (its shared-memory windows, with
clamped borders), at phi_normal 32 and 128 (its generic instance), and
to the bit at phi_normal 80, 3, 2.5, 0.5 and 0 (torch.pow's CUDA rule)
and at steps 126, 127, 128 and 256 (past 126 the windows' columns lie on
the step's lattice); K2 on rays that probe its box cull
(tests/torch_tri_probes.py: the box's faces, edges and corners, origins
inside it, zero direction components, parked rays, caps one float either
side of a hit, rays in the planes of tilted triangles, where the
determinant is mostly rounding) against the flower soup, a padded random
soup, a 2048-triangle soup (past 48 KB of shared memory), a soup of
padding and lone tilted triangles, and at the frame's wave shapes; K3 on
its interleaved atlas (and refusing an atlas without it); the procedural
texture stack's kernel (csrc/proctex_kernel.cu) against its plain
versions on texture ids -2..6, negative u - eps, NaN / inf pixels and
lods of None, 0, random and 1e30, and in a whole frame with and without
the authored images (G-buffers and u8 to the bit); K4 on the eight
cases of chip_smoke.py (the frame's own bounce inputs, synthetic lights,
blue noise off, the generic instance at 5 candidates and 2 taps, at 24
and 6 and at 40 and 8, bounce 1 as the frame calls it), every instance
with blue and white noise (a nonzero y0), pixel counts that leave a
ragged last tile, and planes a bulk copy cannot take (not 16-byte
aligned); K4's sin_cos against torch.sin / torch.cos on every angle in
[0, 2π]; K7 (EASU) bit-exact at the rungs' ratios 4:3, 3:2, 2:1 and a
mixed per-axis one, on images with flat patches (no direction), at the
rungs' 1080p shapes, on a downscale and with non-finite pixels; whole
frames on the card at atrous_iterations 9 with phi_normal 80 and at
restir_temporal_samples 6.  The gameplay path: K4's lit instances (8
candidates and 3 taps at bounce 0, 2 and 0 at bounces 1-2) on a lit
frame's own calls, with blue and white noise; pick_block on the card
(one K1 launch on one ray) equal to the CPU's; a lantern, a bulk edit
that grows the exception list and the dev-panel settings in frames on
the card, K1 to the bit on the grown list.  The frame as a CUDA graph
at 320×180 (chip_smoke's graph checks): the 8-frame batch against eager
frames of a copy, bit for bit, natively and at the 1/2 rung; one-frame
replays along the flythrough and after an edit (written in place: no
capture); K4's generic instance replayed; launch counts under replay;
graph memory flat over 20 edits; a new capture after each call that
replaces what a graph reads, none after an overlay (written in place).
Live entities at 320×180 (chip_smoke's
entities phase): a walking character's replays against eager frames of
a copy, bit for bit, with one capture and none over 10 more frames, by
day (a 128-row soup) and at night with the lantern (256 rows); K2 on
that frame's own five launches and K3 on its own call, bit for bit;
edits that keep the shapes replayed bit-exact without a capture, a
growing edit captured once.  The apps (chip_smoke's interactive and
offline phases): a scripted keyboard session at 320×180 through the
interactive app's loop (captures as the rule predicts, frames not blank,
the save loaded back, the replay after a live edit equal to an eager
frame), and offline.main --test-canonical at 128².  The frame as 4
extended row bands at 1080p (chip_smoke's bands phase): the first banded
frame equal to the unsharded one (u8, own rows of the slow history and of
every reservoir plane to the bit), and K4 at the bands from rows 0, 233
and 736 (344 rows) on a banded frame's own calls, bit for bit.  The
profiling tools: device_trace at 320×180 finds K1-K6 under their own
kernel names, each with the launch counters' count for the same eager
frames, and K7 nowhere at scale 1; timing.time_piece times each of its
captures apart and reports their mean.  The tracer (utils/perf.py): a
replay's five device stamps, its stages against its first-to-last
stamp, its frames equal to those of a graph captured without stamps."""
import os

import numpy as np
import pytest
import torch

from rtvb_tpu_torch import kernels as K

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    K.LIBRARY.get()
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def engine(cuda):
    from rtvb_tpu_torch.render.renderer import Engine, slice_settings
    return Engine(settings=slice_settings(200, 120), device=cuda)


def _bits_equal(a, b):
    if a.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    return bool((a == b).all())


def _rays(engine, seed, shape=(90, 130)):
    """Random rays; every 7th is the path tracer's parked ray (from
    (0, 1e4, 0) straight up, as a dead path's next bounce is traced) and
    every 5th runs in a vertical plane (an exactly zero x or z)."""
    g = torch.Generator().manual_seed(seed)
    dev = engine.device
    o = torch.rand(3, *shape, generator=g) * torch.tensor(
        [64.0, 20, 64]).reshape(3, *[1] * len(shape))
    d = torch.randn(3, *shape, generator=g)
    d = d / d.norm(dim=0, keepdim=True).clamp(min=1e-6)
    o, d = o.reshape(3, -1), d.reshape(3, -1)
    o[:, ::7] = torch.tensor([[0.0], [1e4], [0.0]])
    d[:, ::7] = torch.tensor([[0.0], [1.0], [0.0]])
    d[0, 1::10] = 0.0
    d[2, 6::10] = 0.0
    return (tuple(c.reshape(shape).contiguous().to(dev) for c in o),
            tuple(c.reshape(shape).contiguous().to(dev) for c in d))


def _trace_both(engine, shape, any_hit, seed):
    from rtvb_tpu_torch.ops import dda
    o, d = _rays(engine, seed, shape)
    g = torch.Generator().manual_seed(seed + 100)
    cap = (torch.rand(shape, generator=g) * 60 + 0.5).to(engine.device)
    a = dda.trace_cuda(o, d, engine._tables, engine._tp, cap, any_hit)
    b = dda.trace_plain(o, d, engine._tables, engine._tp, cap, any_hit)
    fields = ("hit", "t") if any_hit else dda.HitRecord._fields
    for f in fields:
        assert getattr(a, f).shape == shape, f
        assert _bits_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("any_hit", [False, True])
def test_trace_kernel_matches_plain(engine, any_hit):
    from rtvb_tpu_torch.ops import dda
    o, d = _rays(engine, 1)
    cap = torch.rand(o[0].shape, generator=torch.Generator().manual_seed(2))
    cap = (cap * 60 + 0.5).to(engine.device)
    a = dda.trace_cuda(o, d, engine._tables, engine._tp, cap, any_hit)
    b = dda.trace_plain(o, d, engine._tables, engine._tp, cap, any_hit)
    fields = ("hit", "t") if any_hit else dda.HitRecord._fields
    for f in fields:
        assert _bits_equal(getattr(a, f), getattr(b, f)), f


# the frame's ray waves: bounce 0 and its shadow rays at 1920×1080, the
# half-res GI bounces at 960×540, their two shadow waves batched to 1080×960
@pytest.mark.parametrize("shape", [(1080, 1920), (540, 960), (1080, 960)])
@pytest.mark.parametrize("any_hit", [False, True])
def test_trace_kernel_frame_shapes(engine, shape, any_hit):
    _trace_both(engine, shape, any_hit, 7)


# K1 takes rays in chunks of 32: one ray, a part chunk, a chunk and a
# part, eight chunks and a part, 150 rays in 3 rows; no ray at all
@pytest.mark.parametrize("shape", [(1,), (31,), (33,), (257,), (3, 50),
                                   (0,)])
@pytest.mark.parametrize("any_hit", [False, True])
def test_trace_kernel_ragged_ray_sets(engine, shape, any_hit):
    _trace_both(engine, shape, any_hit, 8)


def test_tri_kernel_matches_plain(engine):
    from rtvb_tpu_torch.ops import triangles
    o, d = _rays(engine, 3)
    tri = engine.entity_buffers().tri_packed
    a = triangles.intersect_packed_cuda(o, d, tri)
    b = triangles.intersect_packed_plain(o, d, tri)
    for f in triangles.TriHit._fields:
        assert _bits_equal(getattr(a, f), getattr(b, f)), f


def _tri_both(o, d, tri, cap):
    from rtvb_tpu_torch.ops import triangles
    a = triangles.intersect_packed_cuda(o, d, tri, cap)
    b = triangles.intersect_packed_plain(o, d, tri, cap)
    assert a.hit.dtype == torch.bool
    for f in triangles.TriHit._fields:
        assert _bits_equal(getattr(a, f), getattr(b, f)), f
    return b


def _soup(name, engine):
    from torch_tri_probes import random_soup
    if name == "flowers":
        return engine.entity_buffers().tri_packed
    if name == "random+padding":
        soup = np.concatenate([random_soup(40, 5),
                               np.zeros((24, 9), np.float32)])
    elif name == "2048":                 # 73 KB: past the default 48 KB
        soup = random_soup(2048, 6, size=0.7)
    else:                                # all padding: every ray misses
        soup = np.zeros((16, 9), np.float32)
    return torch.from_numpy(soup).to(engine.device)


# the box cull where rounding could make it wrong (tests/torch_tri_probes)
@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("soup", ["flowers", "random+padding", "2048",
                                  "padding"])
def test_tri_kernel_box_probes(engine, soup, capped):
    from torch_tri_probes import probe_rays
    tri = _soup(soup, engine)
    o, d, cap = probe_rays(tri.cpu().numpy(), seed=9)
    dev = engine.device
    o = tuple(torch.from_numpy(a).to(dev) for a in o)
    d = tuple(torch.from_numpy(a).to(dev) for a in d)
    b = _tri_both(o, d, tri, torch.from_numpy(cap).to(dev) if capped
                  else None)
    n_hit = int(b.hit.sum())
    assert n_hit == 0 if soup == "padding" else n_hit > 20


# the frame's wave shapes: random rays (every 7th parked, every 5th with
# a zero x or z), capped, against the flower soup and the 2048 soup
@pytest.mark.parametrize("shape", [(1080, 1920), (540, 960), (1080, 960),
                                   (7, 13), (0,)])
@pytest.mark.parametrize("soup", ["flowers", "2048"])
def test_tri_kernel_frame_shapes(engine, soup, shape):
    o, d = _rays(engine, 12, shape)
    g = torch.Generator().manual_seed(13)
    cap = (torch.rand(shape, generator=g) * 60 + 0.5).to(engine.device)
    tri = _soup(soup, engine)
    _tri_both(o, d, tri, cap)
    _tri_both(o, d, tri, None)


# rays in the planes of lone tilted triangles: the cull drops none of the
# plain version's hits, however far off the triangle rounding puts them
@pytest.mark.parametrize("seed", [0, 1])
def test_tri_kernel_in_plane_rays(engine, seed):
    from torch_tri_probes import in_plane_rays, in_plane_soup
    soup = in_plane_soup(seed)
    o, d = in_plane_rays(soup, seed, n=2000)
    dev = engine.device
    o = tuple(torch.from_numpy(a).to(dev) for a in o)
    d = tuple(torch.from_numpy(a).to(dev) for a in d)
    b = _tri_both(o, d, torch.from_numpy(soup).to(dev), None)
    assert int(b.hit.sum()) >= 10


def test_tri_kernel_plane_ray(engine):
    """The ray in PLANE_ROW's plane gets the plain version's hit, t = 2,
    u = 0, v = 1, though it passes the triangle's padded box."""
    from rtvb_tpu_torch.ops import triangles
    from torch_tri_probes import PLANE_RAY, PLANE_ROW
    dev = engine.device
    o, d = (tuple(torch.tensor(a[i:i + 1], device=dev) for i in range(3))
            for a in PLANE_RAY)
    h = triangles.intersect_packed_cuda(
        o, d, torch.from_numpy(PLANE_ROW[None]).to(dev))
    assert (bool(h.hit[0]), int(h.tri[0]), float(h.t[0]), float(h.u[0]),
            float(h.v[0])) == (True, 0, 2.0, 0.0, 1.0)


def test_tri_wrapper_counts_and_raises(engine):
    from rtvb_tpu_torch.ops import triangles
    o, d = _rays(engine, 14, (20, 30))
    tri = engine.entity_buffers().tri_packed
    before = triangles.TRI.launches
    triangles.intersect_packed(o, d, tri)
    assert triangles.TRI.launches == before + 1
    with pytest.raises(TypeError):
        triangles.intersect_packed(o, d, tri, torch.zeros(20, 30,
                                                          dtype=torch.float64,
                                                          device=engine.device))
    with pytest.raises(ValueError):
        triangles.intersect_packed_cuda(o, d, tri.cpu())
    with pytest.raises(ValueError):
        triangles.intersect_packed(o, d, torch.zeros(
            triangles.MAX_TRIS + 1, 9, device=engine.device))
    assert triangles.TRI.launches == before + 1


def test_texture_kernel_matches_plain(engine):
    from rtvb_tpu_torch.assets import image_textures as it
    g = torch.Generator().manual_seed(4)
    dev = engine.device
    H, W = 70, 200
    t_count = it.atlas_count(engine.texture_atlas)
    tid = (torch.randint(-1, t_count, (H, W), generator=g,
                         dtype=torch.int32)).to(dev)
    u = (torch.rand(H, W, generator=g) * 3).to(dev)
    v = (torch.rand(H, W, generator=g) * 3).to(dev)
    lvl = it.level_from_lod((torch.rand(H, W, generator=g) * 0.02).to(dev))
    atlas = engine.texture_atlas
    a = it._sample_cuda(atlas, t_count, tid, u, v, lvl)
    b = it._sample_ref(atlas, t_count, tid, u, v, lvl)
    use = tid >= 0
    for x, y in zip(a, b):
        assert _bits_equal(torch.where(use, x, 0.0), torch.where(use, y, 0.0))
    # the kernel reads only the interleaved copy
    before = it.TEXTURE.launches
    with pytest.raises(ValueError):
        it._sample_cuda(atlas._replace(hi4=None), t_count, tid, u, v, lvl)
    assert it.TEXTURE.launches == before


def _proctex_planes(dev, lod_kind, seed=5, shape=(70, 200)):
    """Texture ids in -2..6, u and v in [-0.5, 3.5) (u - eps < 0 too), the
    lod of `lod_kind`, and NaN / inf pixels in u, v and the lod."""
    g = torch.Generator().manual_seed(seed)
    tid = torch.randint(-2, 7, shape, generator=g, dtype=torch.int32)
    u = torch.rand(shape, generator=g) * 4.0 - 0.5
    v = torch.rand(shape, generator=g) * 4.0 - 0.5
    lod = {"none": None, "0": torch.zeros(shape),
           "random": torch.rand(shape, generator=g) * 0.05,
           "1e30": torch.full(shape, 1e30)}[lod_kind]
    bad = (float("nan"), float("inf"), -float("inf"))
    for k, x in enumerate(bad):
        u[k::23, 5 + k::31] = x
        v[k + 7::29, k::37] = x
        if lod is not None:
            lod[k + 3::19, k + 11::41] = x
    return (tid.to(dev), u.to(dev), v.to(dev),
            None if lod is None else lod.to(dev))


@pytest.mark.parametrize("lod_kind", ["none", "0", "random", "1e30"])
@pytest.mark.parametrize("entry", ["scale", "normal_delta"])
def test_proctex_kernel_matches_plain(cuda, entry, lod_kind):
    """csrc/proctex_kernel.cu against the plain texture stack, bit for bit;
    one launch a call; a wrong dtype or a CPU plane raises before any."""
    from rtvb_tpu_torch.assets import textures as tx
    tid, u, v, lod = _proctex_planes(cuda, lod_kind)
    if entry == "scale":
        fn, plain = tx.sample_scale, tx._sample_scale_plain
    else:
        fn, plain = tx.sample_normal_delta, tx._sample_normal_delta_plain
    before = tx.PROCTEX.launches
    got = fn(tid, u, v, lod)
    assert tx.PROCTEX.launches == before + 1
    want = plain(tid, u, v, lod)
    if entry == "scale":
        got, want = (got,), (want,)
    for a, b in zip(got, want, strict=True):
        assert _bits_equal(a, b)
    with pytest.raises(TypeError):
        fn(tid.to(torch.int64), u, v, lod)
    with pytest.raises(ValueError):
        fn(tid.cpu(), u, v, lod)
    with pytest.raises(ValueError):
        fn(tid, u, v.cpu(), lod)
    assert tx.PROCTEX.launches == before + 1


@pytest.mark.parametrize("bilinear", [False, True])
def test_warp_kernel_matches_plain(cuda, bilinear):
    from rtvb_tpu_torch.ops import warp_kernel
    g = torch.Generator().manual_seed(5)
    H, W = 37, 150
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    sy = (yy + 3 * torch.randn(H, W, generator=g)).to(cuda)
    sx = (xx + 3 * torch.randn(H, W, generator=g)).to(cuda)
    if bilinear:
        hist = torch.randn(7, H, W, generator=g).to(cuda)
        a = warp_kernel._warp_cuda(hist, sy, sx, True, 6)
        b = warp_kernel.warp_bilinear_ref(hist, sy, sx, 6)
    else:
        hist = torch.randint(-2 ** 31, 2 ** 31 - 1, (8, H, W), generator=g,
                             dtype=torch.int32).to(cuda).view(torch.float32)
        a = warp_kernel._warp_cuda(hist, sy, sx, False, 0)
        b = warp_kernel.warp_nearest_ref(hist, sy, sx)
    assert bool((a[1] == b[1]).all())
    assert _bits_equal(a[0], b[0])


@pytest.mark.parametrize("step", [1, 2, 4, 8, 16])
def test_atrous_kernel_matches_plain(cuda, step):
    from rtvb_tpu_torch.ops.denoise import atrous_kernel, passes
    g = torch.Generator().manual_seed(step)
    H, W = 45, 70
    illum = torch.rand(H, W, 3, generator=g).to(cuda)
    var = (torch.rand(H, W, generator=g) * 0.1).to(cuda)
    depth = (10 + 20 * torch.rand(H, W, generator=g)).to(cuda)
    depth[:4, :9] = 1e30
    n = torch.randn(H, W, 3, generator=g) * 0.2
    n[..., 1] += 1
    normal = (n / n.norm(dim=-1, keepdim=True)).to(cuda)
    a = atrous_kernel._atrous_cuda(illum, var, depth, normal, step, 2.0,
                                   64.0, 0.05)
    b = passes.atrous_pass_plain(illum, var, depth, normal, step, 2.0, 64.0,
                                 0.05)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(),
                                   rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def gbuffer_1080p(cuda):
    """The 1080p frame's G-buffer planes as the denoiser hands them to K6,
    with a random variance plane."""
    from rtvb_tpu_torch.render.renderer import Engine, slice_settings
    eng = Engine(settings=slice_settings(1920, 1080), device=cuda)
    g, _ = eng.render_gbuffers()
    var = torch.rand(g.depth.shape,
                     generator=torch.Generator().manual_seed(9)) * 0.1
    return (torch.stack(g.illum, dim=-1).contiguous(), var.to(cuda),
            g.depth.contiguous(), torch.stack(g.normal, dim=-1).contiguous())


def _atrous_inputs(H, W, seed, device):
    g = torch.Generator().manual_seed(seed)
    illum = torch.rand(H, W, 3, generator=g)
    var = torch.rand(H, W, generator=g) * 0.1
    depth = 10 + 20 * torch.rand(H, W, generator=g)
    depth[: H // 3, : W // 4] = 1e30
    n = torch.randn(H, W, 3, generator=g) * 0.2
    n[..., 1] += 1
    normal = n / n.norm(dim=-1, keepdim=True)
    return tuple(t.contiguous().to(device)
                 for t in (illum, var, depth, normal))


def _atrous_against_plain(args, step, phi_normal):
    from rtvb_tpu_torch.ops.denoise import atrous_kernel, passes
    a = atrous_kernel._atrous_cuda(*args, step, 2.0, phi_normal, 0.05)
    b = passes.atrous_pass_plain(*args, step, 2.0, phi_normal, 0.05)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(),
                                   rtol=1e-5, atol=1e-7)


# steps 1-16, and 24 and 32, whose windows pass the default 48 KB of
# shared memory
@pytest.mark.parametrize("step", list(range(1, 17)) + [24, 32])
@pytest.mark.parametrize("image", ["1080p", "7x13", "1919x1079"])
def test_atrous_kernel_windows(cuda, gbuffer_1080p, image, step):
    if image == "1080p":
        args = gbuffer_1080p
    else:
        W, H = map(int, image.split("x"))
        args = _atrous_inputs(H, W, step, cuda)
    _atrous_against_plain(args, step, 64.0)


# phi_normal other than the shipped 64: the generic instance, its
# squarings counted at run time
@pytest.mark.parametrize("step", [1, 3, 8, 24, 32])
@pytest.mark.parametrize("phi_normal", [32.0, 128.0])
@pytest.mark.parametrize("image", ["7x13", "1919x1079"])
def test_atrous_kernel_generic_instance(cuda, image, phi_normal, step):
    W, H = map(int, image.split("x"))
    _atrous_against_plain(_atrous_inputs(H, W, step, cuda), step,
                          phi_normal)


def _atrous_bits(args, step, phi_normal):
    from rtvb_tpu_torch.ops.denoise import atrous_kernel, passes
    before = atrous_kernel.ATROUS.launches
    a = atrous_kernel._atrous_cuda(*args, step, 2.0, phi_normal, 0.05)
    assert atrous_kernel.ATROUS.launches == before + 1
    b = passes.atrous_pass_plain(*args, step, 2.0, phi_normal, 0.05)
    for x, y in zip(a, b):
        assert _bits_equal(x, y)


# step 126's window of consecutive columns is the widest that fits the
# 227 KB a block may hold on an H100; from 127 the columns lie on the
# step's lattice too; every step launches and matches to the bit
@pytest.mark.parametrize("step", [126, 127, 128, 256])
@pytest.mark.parametrize("image", ["40x300", "1919x1079"])
def test_atrous_kernel_windows_past_shared_memory(cuda, image, step):
    W, H = map(int, image.split("x"))
    _atrous_bits(_atrous_inputs(H, W, step, cuda), step, 64.0)


# any phi_normal (the dev panel steps 64 to 80.0): torch.pow's rule on
# CUDA, held to the bit, at a step with a compile-time instance and not
@pytest.mark.parametrize("phi_normal", [80.0, 3.0, 2.5, 0.5, 0.0])
@pytest.mark.parametrize("step", [1, 8, 128])
def test_atrous_kernel_any_phi_normal(cuda, phi_normal, step):
    _atrous_bits(_atrous_inputs(45, 300, 7, cuda), step, phi_normal)


def test_wrapper_raises_on_wrong_input(cuda):
    from rtvb_tpu_torch.ops import warp_kernel
    hist = torch.zeros(8, 16, 16, device=cuda)
    sy = torch.zeros(16, 16, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        warp_kernel.warp_nearest(hist, sy, sy)
    with pytest.raises(ValueError):
        warp_kernel.warp_nearest(hist, torch.zeros(16, 32, device=cuda)[:, ::2],
                                 torch.zeros(16, 16, device=cuda))


@pytest.fixture(scope="module")
def shade_cases(cuda):
    import chip_smoke
    from rtvb_tpu_torch.core.config import Settings
    from rtvb_tpu_torch.render.renderer import Engine
    eng = Engine(settings=Settings().replace(rendering={
        "render_width": 200, "render_height": 122}), device=cuda)
    eng.render_realtime_device()      # reservoirs with content
    return chip_smoke, chip_smoke.shade_cases(eng)


def _shade_against_plain(smoke, args, kw, name=""):
    """K4 against its plain version: chip_smoke's bar, and every output
    equal to the bit."""
    from rtvb_tpu_torch.render import ris_kernel as RK
    a = RK.fused_shade_cuda(*args, **kw)
    b = RK.fused_shade_plain(*args, **kw)
    torch.cuda.synchronize()
    d = smoke.shade_diff(a, b)
    print(name, d)
    smoke.shade_check(d)
    assert d["int_agree"] == 1.0 and not d["float_bits_differ"], d


def _shade_case(cases, case):
    name = next(n for n in cases if n.startswith(f"({case})"))
    return name, cases[name]


@pytest.mark.parametrize("case", ["a", "b", "c", "d", "e", "f", "g", "h"])
def test_shade_kernel_matches_plain(shade_cases, case):
    smoke, cases = shade_cases
    name, (args, kw) = _shade_case(cases, case)
    _shade_against_plain(smoke, args, kw, name)


def _map_planes(args, kw, fn):
    """args, kw with fn applied to every pixel plane (the surface, depth,
    tap and blue-noise planes; not the tables)."""
    def m(x):
        if isinstance(x, torch.Tensor):
            return fn(x)
        if isinstance(x, (tuple, list)):
            return type(x)(m(y) for y in x)
        return x
    return (tuple(args[:8]) + tuple(m(a) for a in args[8:]),
            {k: m(v) for k, v in kw.items()})


def _white_noise(args, kw, y0):
    """The case with blue noise off, its rows offset by y0."""
    return ((args[0]._replace(blue_noise=False), args[1], y0)
            + tuple(args[3:]), dict(kw, bn=None))


# every compile-time instance and the generic one, with blue noise and
# white (rows offset by a nonzero y0, which only white noise reads)
@pytest.mark.parametrize("noise", ["blue", "white y0=61"])
@pytest.mark.parametrize("case", ["a", "b", "c", "e", "f", "g"])
def test_shade_kernel_instances(shade_cases, case, noise):
    smoke, cases = shade_cases
    name, (args, kw) = _shade_case(cases, case)
    if noise != "blue":
        args, kw = _white_noise(args, kw, 61)
    _shade_against_plain(smoke, args, kw, f"{name} {noise}")


# pixel counts that leave a ragged last 128-pixel tile (or no whole tile)
@pytest.mark.parametrize("hw", [(1, 1), (5, 7), (3, 43), (11, 128),
                                (61, 97)])
@pytest.mark.parametrize("case", ["a", "d", "e", "f", "g"])
def test_shade_kernel_ragged_tiles(shade_cases, case, hw):
    smoke, cases = shade_cases
    name, (args, kw) = _shade_case(cases, case)
    h, w = hw
    args, kw = _map_planes(args, kw, lambda t: t[..., :h, :w].contiguous())
    _shade_against_plain(smoke, args, kw, f"{name} {h}x{w}")


def _misaligned(t):
    """A contiguous copy of t whose data starts 4 bytes past a 16-byte
    boundary (bulk copies need 16)."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4 and out.is_contiguous()
    return out


# planes a bulk copy cannot take: every plane, or only the taps' planes
@pytest.mark.parametrize("which", ["all", "taps"])
@pytest.mark.parametrize("case", ["a", "e", "h"])
def test_shade_kernel_misaligned_planes(shade_cases, case, which):
    smoke, cases = shade_cases
    name, (args, kw) = _shade_case(cases, case)
    if which == "all":
        args, kw = _map_planes(args, kw, _misaligned)
    else:
        _, kw2 = _map_planes((), {"taps": kw["taps"]}, _misaligned)
        kw = dict(kw, taps=kw2["taps"])
    _shade_against_plain(smoke, args, kw, f"{name} misaligned {which}")


def test_sin_cos_matches_torch_on_every_angle(cuda):
    """K4's sin_cos (one sincosf) gives torch.sin's and torch.cos's bits
    (what the plain version calls) for every float in [0, float32(2π)]:
    the angles 2π·u that K4 takes them of."""
    from rtvb_tpu_torch.render import ris_kernel as RK
    top = int(np.array(2 * np.pi, np.float32).view(np.int32))
    step = 1 << 26
    for lo in range(0, top + 1, step):
        bits = torch.arange(lo, min(lo + step, top + 1), dtype=torch.int32,
                            device=cuda)
        x = bits.view(torch.float32)
        s, c = RK.sin_cos_cuda(x)
        assert torch.equal(s.view(torch.int32),
                           torch.sin(x).view(torch.int32)), lo
        assert torch.equal(c.view(torch.int32),
                           torch.cos(x).view(torch.int32)), lo


def test_shade_wrapper_counts_and_raises(shade_cases):
    from rtvb_tpu_torch.render import ris_kernel as RK
    _, cases = shade_cases
    args, kw = next(iter(cases.values()))
    before = RK.SHADE.launches
    RK.fused_shade(*args, **kw)
    assert RK.SHADE.launches == before + 1
    with pytest.raises(TypeError):
        RK.fused_shade(*args[:3], args[3].double(), *args[4:], **kw)
    assert RK.SHADE.launches == before + 1


# (in_h, in_w, out_h, out_w): 4:3, 3:2, 2:1 on ragged sizes; 214×120 →
# 320×180 (2/3 of 320×180, the axes' ratios differ)
EASU_CASES = {"4:3": (45, 60, 60, 80), "3:2": (40, 66, 60, 99),
              "2:1": (37, 50, 74, 100), "mixed": (120, 214, 180, 320),
              "1/2 rung": (540, 960, 1080, 1920),
              "2/3 rung": (720, 1280, 1080, 1920),
              "3/4 rung": (810, 1440, 1080, 1920),
              "downscale": (90, 130, 37, 51)}


def _easu_image(h, w, seed, device):
    g = torch.Generator().manual_seed(seed)
    img = torch.rand(h, w, 3, generator=g)
    img[: h // 3, : w // 3] = 0.25          # flat: no direction there
    return img.to(device)


@pytest.mark.parametrize("case", list(EASU_CASES))
def test_easu_kernel_matches_plain(cuda, case):
    from rtvb_tpu_torch.ops import easu_kernel
    h, w, oh, ow = EASU_CASES[case]
    img = _easu_image(h, w, 6, cuda)
    a = easu_kernel._easu_cuda(img, oh, ow)
    b = easu_kernel.easu_plain(img, oh, ow)
    assert a.shape == (oh, ow, 3)
    assert _bits_equal(a, b)


# non-finite pixels: the kernel's NaN-propagating clamps give the plain
# version's bits, NaNs included
def test_easu_kernel_non_finite_pixels(cuda):
    from rtvb_tpu_torch.ops import easu_kernel
    img = _easu_image(37, 50, 8, cuda)
    img[5, 7] = float("nan")
    img[20, 30, 1] = float("inf")
    img[30, 3, 2] = -float("inf")
    a = easu_kernel._easu_cuda(img, 74, 100)
    b = easu_kernel.easu_plain(img, 74, 100)
    assert bool(torch.isnan(b).any())
    assert _bits_equal(a, b)


def test_easu_wrapper_counts_and_raises(cuda):
    from rtvb_tpu_torch.ops import easu_kernel
    img = _easu_image(20, 30, 7, cuda)
    before = easu_kernel.EASU.launches
    easu_kernel.easu(img, 40, 60)
    assert easu_kernel.EASU.launches == before + 1
    with pytest.raises(TypeError):
        easu_kernel.easu(img.double(), 40, 60)
    with pytest.raises(ValueError):
        easu_kernel.easu(img.transpose(0, 1), 60, 40)
    with pytest.raises(ValueError):
        easu_kernel._easu_cuda(img.cpu(), 40, 60)
    assert easu_kernel.EASU.launches == before + 1


# whole frames on the card at settings the dev panel reaches past the
# shipped ones: K6 at steps up to 256 with phi_normal 80, K4's generic
# instance with 6 taps; each launched as the frame runs it
@pytest.mark.parametrize("setting", ["atrous 9, phi_normal 80",
                                     "restir taps 6"])
def test_engine_frame_at_widened_settings(cuda, setting):
    from rtvb_tpu_torch.core.config import Settings
    from rtvb_tpu_torch.render.renderer import Engine
    st = Settings().replace(rendering={"render_width": 256,
                                       "render_height": 144})
    if setting.startswith("atrous"):
        st = st.replace(denoising={"atrous_iterations": 9,
                                   "phi_normal": 80.0})
    else:
        st = st.replace(rendering={"restir_temporal_samples": 6})
    eng = Engine(settings=st, device=cuda)
    K.reset_launch_counts()
    for _ in range(2):
        out = eng.render_realtime_device()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["atrous"] == 2 * st.denoising.atrous_iterations
    assert counts["shade"] == 2 * st.rendering.total_bounce_limit
    u8 = out.cpu().numpy()
    assert u8.shape == (144, 256, 3) and u8.std() > 1.0


# the gameplay path: a lantern at night, the picked block's highlight
@pytest.fixture(scope="module")
def lit_engine(cuda):
    import chip_smoke
    from rtvb_tpu_torch.render.renderer import Engine
    eng = Engine(settings=chip_smoke.gameplay_settings(200, 122),
                 device=cuda)
    chip_smoke.night_with_lantern(eng)
    eng.render_realtime_device()      # reservoirs with lantern samples
    return chip_smoke, eng


@pytest.mark.parametrize("noise", ["blue", "white y0=61"])
@pytest.mark.parametrize("bounce", [0, 1, 2])
def test_shade_kernel_lit_instances(lit_engine, bounce, noise):
    smoke, eng = lit_engine
    calls = smoke.capture_shade_calls(eng)
    assert [(a[0].n_local, a[0].n_taps) for a, _ in calls] == \
        [(8, 3), (2, 0), (2, 0)]
    args, kw = calls[bounce]
    if noise != "blue":
        args, kw = _white_noise(args, kw, 61)
    _shade_against_plain(smoke, args, kw, f"lit bounce {bounce} {noise}")


@pytest.fixture(scope="module")
def pick_pair(cuda):
    from rtvb_tpu_torch.core.config import Settings
    from rtvb_tpu_torch.render.renderer import Engine
    st = Settings().replace(rendering={"render_width": 64,
                                       "render_height": 36})
    return Engine(settings=st, device=cuda), Engine(settings=st,
                                                    device="cpu")


@pytest.mark.parametrize("pose", [((32.0, 14.0, 8.0), 1.1, -0.9),
                                  ((10.3, 9.5, 20.4), 0.0, -0.15),
                                  ((32.0, 18.0, 8.0), 1.1, -0.35)])
def test_pick_block_matches_cpu(pick_pair, pose):
    gpu, cpu = pick_pair
    pos, yaw, pitch = pose
    for e in pick_pair:
        e.set_camera(pos=pos, yaw=yaw, pitch=pitch)
    K.reset_launch_counts()
    got = gpu.pick_block()
    assert K.launch_counts()["trace"] == 1
    assert got == cpu.pick_block()


def test_engine_gameplay_edits_on_card(cuda):
    import chip_smoke
    from rtvb_tpu_torch.assets import blocks as B
    from rtvb_tpu_torch.ops import dda
    from rtvb_tpu_torch.render.renderer import Engine
    eng = Engine(settings=chip_smoke.gameplay_settings(160, 90),
                 device=cuda)
    pick = chip_smoke.night_with_lantern(eng)
    assert pick[0]
    K.reset_launch_counts()
    out = eng.render_realtime_device()
    assert K.launch_counts()["shade"] == 3
    xyz = chip_smoke.surface_bricks(eng)
    eng.set_blocks(xyz, np.full(len(xyz), B.BRICK, np.uint8))
    assert eng._tables.exc_key.shape[0] == 1024
    traces, _, _, _ = chip_smoke.capture_frame_calls(eng)
    for o, d, cap, any_hit in traces:
        a = dda.trace_cuda(o, d, eng._tables, eng._tp, cap, any_hit)
        b = dda.trace_plain(o, d, eng._tables, eng._tp, cap, any_hit)
        for f in (("hit", "t") if any_hit else dda.HitRecord._fields):
            assert _bits_equal(getattr(a, f), getattr(b, f)), f
    eng.apply_settings(eng.settings.replace(**chip_smoke.DEV_PANEL))
    for _ in range(2):
        out = eng.render_realtime_device()
    u8 = out.cpu().numpy()
    assert u8.shape == (90, 160, 3) and (u8[45, 79:81] == 255).all()


# ---------------------------------------------------------------------------
# the frame as a CUDA graph (chip_smoke's graph phase at 320×180)
# ---------------------------------------------------------------------------

def _graph_settings(**rendering):
    from rtvb_tpu_torch.core.config import Settings
    return Settings().replace(rendering=dict(
        render_width=320, render_height=180, **rendering))


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_graph_batch_matches_eager_frames(cuda, scale):
    import chip_smoke
    K.reset_launch_counts()
    got = chip_smoke.graph_batch_vs_eager(_graph_settings(
        render_scale=scale))
    assert got["batch 2"] == "bit-exact"
    assert (K.launch_counts()["easu"] > 0) == (scale < 1.0)


def test_graph_replay_along_flythrough_and_after_edit(cuda):
    import chip_smoke
    got = chip_smoke.graph_flythrough_vs_eager(_graph_settings())
    assert got["frames"] == 10 and len(got["graph_log"]) == 1


def test_graph_replay_k4_generic_instance(cuda):
    import chip_smoke
    chip_smoke.graph_widened_vs_eager(_graph_settings())


def test_graph_launch_counts_equal_eager(cuda):
    import chip_smoke
    from rtvb_tpu_torch.render.renderer import Engine
    eng = Engine(settings=_graph_settings(), device=cuda)
    eng.render_realtime_device()
    got = chip_smoke.graph_launch_counts(eng, K)
    assert got["replay"]["atrous"] == 4 * 3


def test_graph_memory_flat_over_edits(cuda):
    import chip_smoke
    from rtvb_tpu_torch.render.renderer import Engine
    eng = Engine(settings=_graph_settings(), device=cuda)
    eng.render_realtime_device()
    chip_smoke.memory_cycles(eng, None, 20)
    assert len(eng.graph_log) == 1


def _replays_after(cuda, change):
    """`change` on an engine that has captured its frame and on a copy of
    it, then 3 replays against eager frames of the copy, bit for bit →
    (captures after the change, graphs held)."""
    import copy

    import chip_smoke
    from rtvb_tpu_torch.assets import blocks as B
    from rtvb_tpu_torch.render.renderer import Engine
    eng = Engine(settings=_graph_settings(), device=cuda)
    eng.render_realtime_device()
    ref = copy.copy(eng)
    ov = np.zeros((180, 320, 4), np.uint8)
    ov[10:30, 20:90] = (200, 40, 40, 200)
    for e in (eng, ref):
        if change == "set_block":
            e.set_block(30, 25, 30, B.LANTERN)
        elif change == "set_sky":
            e.set_sky(time_of_day=8.0)
        elif change == "apply_settings":
            e.apply_settings(e.settings.replace(
                post_processing={"lens_flare": True}))
        elif change == "set_render_scale":
            e.set_render_scale(2.0 / 3.0)
        else:
            e.set_ui_overlay(ov)
    n = len(eng.graph_log)
    for i in range(3):
        out = eng.render_realtime_device()
        chip_smoke.frames_equal(out, ref._eager_frame(),
                                f"{change} frame {i}")
        chip_smoke.states_equal(eng, ref, f"{change} frame {i}")
    if change == "set_ui_overlay":
        assert (out[20, 50].cpu().numpy() != 0).any()
    return len(eng.graph_log) - n, len(eng._graphs)


@pytest.mark.parametrize("change", ["set_block", "set_sky", "apply_settings",
                                    "set_render_scale"])
def test_graph_recaptured_after_a_change(cuda, change):
    """Each call that replaces a tensor the graph reads: the next frame
    captures anew (the stale graph is released, never replayed) and the
    replays after it equal eager frames of a copy, bit for bit.  The
    edit is the first lantern (it grows the light table and the soup and
    lights the frame): an edit that keeps the shapes replays on
    (test_entity_edits_keep_the_graph)."""
    assert _replays_after(cuda, change) == (1, 1)


def test_graph_replays_after_an_overlay(cuda):
    """set_ui_overlay writes the overlay in place: the graph replays on,
    the replays equal eager frames of a copy with the same overlay."""
    assert _replays_after(cuda, "set_ui_overlay") == (0, 1)


# ---------------------------------------------------------------------------
# live entities: a walking character in the captured frame (chip_smoke's
# entities phase at 320×180)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lantern", [False, True])
def test_entity_walk_replays_match_eager(cuda, lantern):
    """10 replays of a walking character against eager frames of a copy,
    bit for bit, with one capture; then 10 more walking frames capture
    nothing (graph_log does not grow)."""
    import chip_smoke
    eng, ch = chip_smoke.entity_engine(
        _graph_settings(block_highlight=True), lantern)
    got = chip_smoke.entity_walk_vs_eager(eng, ch, 10)
    assert got["captures"] == 1
    assert got["soup_rows"] == (256 if lantern else 128)
    n = len(eng.graph_log)
    for _ in range(10):
        chip_smoke.walk(ch, eng)
        eng.render_realtime_device()
    assert len(eng.graph_log) == n


@pytest.mark.parametrize("lantern", [False, True])
def test_entity_frame_tri_and_texture_match_plain(cuda, lantern):
    """K2 on the frame's own five launches against the soup with the
    character and K3 on the frame's own call, bit for bit."""
    import chip_smoke
    eng, ch = chip_smoke.entity_engine(
        _graph_settings(block_highlight=True), lantern)
    for _ in range(2):
        chip_smoke.walk(ch, eng)
        eng.render_realtime_device()
    rep = chip_smoke.Report()
    got = chip_smoke.entity_kernel_cases(eng, rep, "entity frame")
    assert got["rows"] == (256 if lantern else 128)
    assert got["character_pixels"] > 0
    assert [c["kernel"] for c in rep.cases] == ["tri"] * 5 + ["texture"]


@pytest.mark.parametrize("authored", [True, False])
def test_frame_proctex_kernel_matches_plain(cuda, authored, monkeypatch):
    """The path trace's G-buffers and the u8 frame with the texture stack
    on its kernel, and on a copy of the engine with the plain versions
    patched in, bit for bit: with the authored images as shipped, and
    without them, where the stack's values reach the albedo and the
    normal.  Two launches a frame (normal mapping on)."""
    import copy

    from rtvb_tpu_torch.assets import textures as tx
    from rtvb_tpu_torch.render.renderer import Engine
    eng = Engine(settings=_graph_settings(authored_textures=authored),
                 device=cuda)
    ref = copy.copy(eng)
    before = tx.PROCTEX.launches
    g_kernel, _ = eng.render_gbuffers()
    u8_kernel = eng._eager_frame()
    assert tx.PROCTEX.launches == before + 4
    monkeypatch.setattr(tx, "sample_scale", tx._sample_scale_plain)
    monkeypatch.setattr(tx, "sample_normal_delta",
                        tx._sample_normal_delta_plain)
    g_plain, _ = ref.render_gbuffers()
    u8_plain = ref._eager_frame()
    assert tx.PROCTEX.launches == before + 4
    for f in g_kernel._fields:
        a, b = getattr(g_kernel, f), getattr(g_plain, f)
        if isinstance(a, tuple):
            assert all(_bits_equal(x, y) for x, y in zip(a, b)), f
        elif a is not None:
            assert _bits_equal(a, b), f
    assert torch.equal(u8_kernel, u8_plain)


def test_entity_edits_keep_the_graph(cuda):
    """Edits that keep every table's shape: no recapture, and the replays
    after them equal eager frames of a copy, bit for bit; a growing edit
    captures once."""
    import copy

    import chip_smoke
    from rtvb_tpu_torch.assets import blocks as B
    eng, ch = chip_smoke.entity_engine(
        _graph_settings(block_highlight=True), False)
    eng.render_realtime_device()
    got = chip_smoke.edits_keeping_shapes(eng, ch, 4)
    assert got["recaptures"] == 0
    ref = copy.copy(eng)
    n = len(eng.graph_log)
    x, z = 30, 12
    y = int(eng.host_world.blocks[x, :, z].nonzero()[0].max()) + 1
    for i in range(3):
        for e in (eng, ref):
            e.set_block(x, y, z, B.SAND if i % 2 == 0 else 0)
        chip_smoke.walk(ch, eng)
        chip_smoke.frames_equal(eng.render_realtime_device(),
                                ref._eager_frame(), f"edit {i}")
        chip_smoke.states_equal(eng, ref, f"edit {i}")
    assert len(eng.graph_log) == n
    assert chip_smoke.growing_edit(eng)["recaptures"] == 1


# ---------------------------------------------------------------------------
# The apps on the card (chip_smoke's interactive and offline phases)
# ---------------------------------------------------------------------------

def test_interactive_session_on_card(cuda, tmp_path):
    """chip_smoke's scripted keyboard session at 320×180 through the app's
    own loop: the captures are the rule's (the first frame, each new rung,
    the dev-panel edit, the lantern), K7 once a frame below scale 1, the
    scales a fresh controller's, every presented frame u8 on the card and
    not blank, the saved world loaded back bit for bit, the first replay
    after the edit equal to an eager frame of a copy."""
    import chip_smoke
    got = chip_smoke.interactive_session(K, 320, 180,
                                         str(tmp_path / "worlds"))
    assert [c["frame"] for c in got["captures"]] == got["predicted"]
    assert got["marks"]["edit"] in got["predicted"]
    assert got["marks"]["lantern"] in got["predicted"]
    assert got["compared_at"] is not None


def test_offline_test_canonical_128_on_card(cuda, tmp_path):
    """offline.main --test-canonical at 128² (8 accumulated frames) on the
    card: its exit code follows its verdict against canonical_render.png,
    the card's frame is "close" or better to the port's CPU render of the
    same run, and it misses the golden no further than the JAX package
    does on the CPU (chip_smoke.REFERENCE_MISSES)."""
    import chip_smoke
    from rtvb_tpu_torch.utils import image_diff
    from rtvb_tpu_torch.utils.image import read_png
    name = "canonical_render.png"
    golden_path = os.path.join(chip_smoke.CANONICAL, name)
    card, rc = chip_smoke.render_golden("offline", 128, 8, None, "cuda",
                                        str(tmp_path / "card"), golden_path)
    cpu, _ = chip_smoke.render_golden("accumulated", 128, 8, None, "cpu",
                                      str(tmp_path / "cpu"), golden_path)
    res = image_diff.compare(card, read_png(golden_path))
    assert rc == (0 if res.verdict in chip_smoke.PASSING else 1)
    assert image_diff.compare(card, cpu).verdict in chip_smoke.PASSING
    ref = chip_smoke.REFERENCE_MISSES.get(name)
    if ref is None:
        assert res.verdict in chip_smoke.PASSING, str(res)
    else:
        assert res.rmse <= ref[0] * 1.1 + 0.5 and res.ssim >= ref[1] - 0.02


# ---------------------------------------------------------------------------
# the frame as 4 extended row bands at 1080p (chip_smoke's bands phase)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def band_frame_1(cuda):
    """The first 4-band 1080p frame (LocalBands, full-res GI) and the
    unsharded frame of the same engine, from fresh states."""
    import chip_smoke as cs
    from rtvb_tpu_torch.parallel.frame import (initial_sharded_state,
                                               sharded_frame_fn)
    from rtvb_tpu_torch.render import restir as restir_mod
    from rtvb_tpu_torch.render.denoiser import initial_denoiser_state
    from rtvb_tpu_torch.render.postprocess import initial_post_state
    from rtvb_tpu_torch.render.renderer import Engine
    eng = Engine(settings=cs.bands_settings(1920, 1080), device=cuda)
    step, layout = sharded_frame_fn(eng, n_devices=4)
    frames = cs.band_frames(eng)
    mono = cs.band_call(eng._build_run(), eng, *frames[0], (
        restir_mod.initial_state(1080, 1920, device=cuda),
        initial_denoiser_state(1080, 1920, device=cuda),
        initial_post_state(cuda)))
    bands = cs.band_call(step, eng, *frames[0], initial_sharded_state(
        eng, 4) + (initial_post_state(cuda),))
    return cs, eng, step, layout, frames, mono, bands


def test_bands_first_1080p_frame_equals_unsharded(band_frame_1):
    cs, eng, _, layout, _, mono, bands = band_frame_1
    assert layout == (270, 344, 37)
    cs.hold_exact(cs.bands_vs_unsharded(0, mono, bands, eng, 4, layout,
                                        "4 bands"), "4 bands frame 1")


@pytest.fixture(scope="module")
def band_shade_calls(band_frame_1):
    """K4's calls in the second banded frame (live reservoirs)."""
    cs, eng, step, _, frames, _, bands = band_frame_1
    calls = cs.capture_shade_calls(
        eng, lambda: cs.band_call(step, eng, *frames[1], bands[1:]))
    return cs, calls


@pytest.mark.parametrize("y0", [0, 233, 736])
def test_shade_kernel_at_band_offsets(band_shade_calls, y0):
    from rtvb_tpu_torch.render import ris_kernel as RK
    cs, calls = band_shade_calls
    mine = [(a, kw) for a, kw in calls if a[2] == y0]
    assert len(mine) == 3           # bounces 0-2 of the band from row y0
    for a, kw in mine:
        assert a[8][0].shape == (344, 1920)
        cs.bit_exact_shade(RK.fused_shade_cuda(*a, **kw),
                           RK.fused_shade_plain(*a, **kw))


def test_device_trace_finds_the_hand_kernels(cuda):
    from rtvb_tpu_torch.tools import device_trace
    res = device_trace.device_trace("cuda", 1.0, frames=2, width=320,
                                    height=180)
    hand = res["eager"]["hand_kernels"]
    for name in ("trace", "tri", "texture", "shade", "warp", "atrous",
                 "proctex"):
        assert hand[name]["count"] == res["launches"][name] > 0, name
    assert hand["easu"]["count"] == res["launches"]["easu"] == 0
    # a hand kernel's launch, which no op makes, names its port function
    fn = {r["name"]: r["count"] for r in res["eager"]["by_function"]}
    assert fn["assets/textures.py:_proctex_cuda"] == hand["proctex"]["count"]
    assert res["eager"]["function_share"] >= 0.95
    assert res["replay"]["kernels_per_frame"] > 0


def test_time_piece_means_over_captures(cuda):
    """Each capture's replays timed apart; replay_ms is their mean."""
    from rtvb_tpu_torch.tools import timing
    x = torch.rand(1 << 20, device=cuda)
    t = timing.time_piece(lambda: x * 2.0 + 1.0, cuda, keep=(x,),
                          n_eager=2, n_replay=3)
    ms = t["replay_ms_by_capture"]
    assert len(ms) == timing.CAPTURES and all(m > 0.0 for m in ms)
    assert t["replay_ms"] == pytest.approx(sum(ms) / len(ms))
    assert t["capture_ms"] > 0.0 and t["eager_ms"] > 0.0


# ---------------------------------------------------------------------------
# the tracer's device stamps (utils/perf.py) at 320×180
# ---------------------------------------------------------------------------

def test_tracer_stamps_each_replay(cuda):
    """A replayed frame records its five stamps, read at the next frame's
    entry: every interval positive, the three stages within 2% of the
    frame's first-to-last stamp, a gap to the frame before; the u8 frames
    equal, bit for bit, those of a copy rendered with the tracer off (its
    graph holds no stamp)."""
    import copy

    from rtvb_tpu_torch.render.renderer import Engine
    from rtvb_tpu_torch.utils import perf
    eng = Engine(settings=_graph_settings(), device=cuda)
    off = copy.copy(eng)
    tracer, prev = perf.TRACER, perf.TRACER.enabled
    try:
        tracer.enabled = True
        tracer.reset()
        on_frames = [eng.render_realtime_device().cpu() for _ in range(4)]
        tracer.read_stamps()
        recs = list(tracer.records)
        tracer.enabled = False
        off_frames = [off.render_realtime_device().cpu() for _ in range(4)]
    finally:
        tracer.enabled = prev
    for a, b in zip(on_frames, off_frames):
        assert torch.equal(a, b)
    (g_on,), (g_off,) = eng._graphs.values(), off._graphs.values()
    assert g_on.stamps.recorded == set(perf.STAMPS)
    assert not g_off.stamps.recorded
    assert [r.n for r in recs] == [0, 1, 2, 3] and tracer.dropped == 0
    for rec in recs[1:]:                  # the replays
        ms = rec.device_ms
        assert set(ms) == set(perf.INTERVALS)
        assert all(v > 0.0 for v in ms.values()), ms
        stages = ms["pathtrace"] + ms["denoise"] + ms["post"]
        assert stages == pytest.approx(ms["frame"], rel=0.02)
        assert rec.gap_ms is not None and rec.gap_ms > 0.0
