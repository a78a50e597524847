"""The port's banded frame (rtvb_tpu_torch/parallel/) against the JAX
package's parallel/ and against the port's own unsharded frame, on the
CPU at small sizes.

* (a) `stencil_reach` and `band_layout` equal JAX's over a grid of
  denoiser settings and heights.
* (b) `halo_exchange_rows`, `global_mean` and `sharded_render` on a 2-rank
  gloo group (one module-scoped run of two spawned ranks, with a
  deadline) against JAX's `shard_map` on two of the conftest's virtual
  devices, at 32×16.
* (d) 8 bands of a 64×64 frame through `LocalBands` (two à-trous steps,
  as tests/test_parallel.py: rows 8, halo 13, ext 34) against the port's
  unsharded full-res-GI frame over 3 frames, two with the camera still,
  then one with it moved, held as chip_smoke's bands phase holds them at
  1080p.  Frame 1 holds the halo-recompute claim to the bit: the u8 frame
  equal, the own rows of the denoiser's `slow` history and of every
  reservoir plane bit-exact.  From frame 2 on, each band reprojects its
  history in its own row coordinates (below), so JAX's tolerances do not
  hold there: frame 2 (camera still) keeps every reservoir plane to the
  bit and the rest at bars set from its readings; frame 3 (camera moved)
  is off by far more.  The same frames with the reprojection computed in
  the image's rows (chip_smoke.image_row_reprojection, a what-if) show
  that this is the whole cause: frame 2 to the bit, frame 3 within JAX's
  tolerances and 1/255.
* (e) `dryrun_multichip(2, "cpu")` over gloo equals `LocalBands` on the
  same engine to the bit.
* The reference caveat behind frames 2-3: ReSTIR's taps and the
  denoiser's history reprojection on a band scale a pixel's v-motion by
  the band's rows, not the image height (the port's warp taps equal
  JAX's on a band; the source row is r - mv·ext).

render_frame's band offsets against JAX's are in
tests/test_torch_band_render.py (its own JAX compile)."""
import os
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from rtvb_tpu.core.camera import camera_rays as jcamera_rays
from rtvb_tpu.core.camera import make_camera as jmake_camera
from rtvb_tpu.core.config import Settings as JSettings
from rtvb_tpu.parallel import frame as jframe
from rtvb_tpu.parallel import mesh as jmesh
from rtvb_tpu.render import restir as jrestir
from rtvb_tpu_torch.core.camera import make_camera
from rtvb_tpu_torch.core.config import Settings
from rtvb_tpu_torch.parallel import frame
from rtvb_tpu_torch.parallel.dryrun import (dryrun_multichip,
                                            dryrun_settings, run_frames,
                                            run_ranks)
from rtvb_tpu_torch.render import restir as restir_mod
from rtvb_tpu_torch.render.denoiser import initial_denoiser_state
from rtvb_tpu_torch.render.postprocess import initial_post_state
from rtvb_tpu_torch.render.renderer import Engine

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import torch_parallel_ranks as ranks  # noqa: E402

# every spawned rank group must be done within this (a run takes ~10 s)
RANKS_DEADLINE_S = 240.0


torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# (a) the band layout
# ---------------------------------------------------------------------------

DENOISERS = [
    {},
    {"atrous_iterations": 2},
    {"atrous_iterations": 0, "firefly_filter": False},
    {"pre_pass": True, "history_fix": False},
    {"atrous_iterations": 9, "pre_pass": True},
]


@pytest.mark.parametrize("dn", DENOISERS, ids=lambda d: str(d) or "shipped")
def test_stencil_reach_and_band_layout_match_jax(dn):
    mine = Settings().replace(denoising=dn).denoising
    ref = JSettings().replace(denoising=dn).denoising
    assert frame.stencil_reach(mine) == jframe.stencil_reach(ref)
    for height, n in ((64, 8), (64, 2), (1080, 4), (1080, 2), (1080, 8),
                      (540, 4), (32, 1), (48, 3)):
        assert frame.band_layout(height, n, mine) == \
            jframe.band_layout(height, n, ref), (height, n)
    with pytest.raises(ValueError):
        frame.band_layout(1080, 7, mine)


def test_band_layout_of_the_1080p_frame():
    """The shipped denoiser at 1080/4: rows 270, halo 37 (2 + 1 + 4 + 30),
    ext 344, the bands at rows 0, 233, 503 and 736."""
    dn = Settings().denoising
    layout = frame.band_layout(1080, 4, dn)
    assert layout == (270, 344, 37)
    assert [frame.band_offset(r, 1080, *layout) for r in range(4)] == \
        [0, 233, 503, 736]


# ---------------------------------------------------------------------------
# (b) the mesh primitives on a 2-rank gloo group
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_ranks():
    n = 2
    with tempfile.TemporaryDirectory() as out_dir:
        run_ranks(ranks.mesh_rank, n, (n, out_dir), RANKS_DEADLINE_S)
        return [torch.load(os.path.join(out_dir, f"mesh{r}.pt"))
                for r in range(n)]


def _jax_mesh(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    return jmesh.make_mesh(n)


def test_halo_exchange_rows_matches_jax(mesh_ranks):
    n = len(mesh_ranks)
    f = jax.jit(jax.shard_map(
        lambda x: jmesh.halo_exchange_rows(x, ranks.MESH_HALO),
        mesh=_jax_mesh(n), in_specs=P("dp"), out_specs=P("dp")))
    want = np.asarray(f(jnp.asarray(ranks.mesh_image())))
    got = torch.cat([r["halo"] for r in mesh_ranks]).numpy()
    np.testing.assert_array_equal(got, want)


def test_global_mean_matches_jax(mesh_ranks):
    n = len(mesh_ranks)
    f = jax.jit(jax.shard_map(
        lambda x: jmesh.global_mean(x)[None],
        mesh=_jax_mesh(n), in_specs=P("dp"), out_specs=P("dp")))
    want = np.asarray(f(jnp.asarray(ranks.mesh_noise())))
    got = np.array([float(r["mean"]) for r in mesh_ranks])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, ranks.mesh_noise().mean(), rtol=1e-6)


def test_sharded_render_matches_jax(mesh_ranks):
    n = len(mesh_ranks)
    jcam = jmake_camera(**ranks.CAMERA)

    def rows_fn(y0, rows, cam):
        _, d = jcamera_rays(cam, ranks.MESH_W, ranks.MESH_H, y0=y0,
                            rows=rows)
        return jnp.stack(d, axis=-1)
    want = np.asarray(jmesh.sharded_render(_jax_mesh(n), rows_fn,
                                           ranks.MESH_H, ranks.MESH_W,
                                           (jcam,)))
    for r in mesh_ranks:       # every rank holds the whole image
        got = r["render"].numpy()
        assert got.shape == want.shape == (ranks.MESH_H, ranks.MESH_W, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # and the rows a single call renders
    mono = ranks.camera_rows(0, ranks.MESH_H, make_camera(**ranks.CAMERA))
    assert torch.equal(mesh_ranks[0]["render"], mono)


# ---------------------------------------------------------------------------
# (d) 8 bands through LocalBands against the unsharded frame
# ---------------------------------------------------------------------------

H = W = 64
N_BANDS = 8


def _band_settings():
    return Settings().replace(
        rendering={"render_width": W, "render_height": H,
                   "half_res_gi": False},
        denoising={"atrous_iterations": 2})


@pytest.fixture(scope="module")
def band_frames():
    """Three frames of the unsharded run, of LocalBands and of LocalBands
    with the reprojection in image rows (the what-if), from the same
    engine (chip_smoke.band_frames' cameras: two still, then moved):
    [(mono, bands, what-if)], each (u8, restir, dstate)."""
    import chip_smoke
    eng = Engine(settings=_band_settings(), device="cpu")
    mono = eng._build_run()
    step, layout = frame.sharded_frame_fn(eng, n_devices=N_BANDS)
    assert layout == (8, 34, 13)
    m = (restir_mod.initial_state(H, W), initial_denoiser_state(H, W),
         initial_post_state())
    s = frame.initial_sharded_state(eng, N_BANDS) + (initial_post_state(),)
    w = frame.initial_sharded_state(eng, N_BANDS) + (initial_post_state(),)
    out = []
    for cam, hist, fi in chip_smoke.band_frames(eng):
        mo = chip_smoke.band_call(mono, eng, cam, hist, fi, m)
        so = chip_smoke.band_call(step, eng, cam, hist, fi, s)
        with chip_smoke.image_row_reprojection(step.bands):
            wo = chip_smoke.band_call(step, eng, cam, hist, fi, w)
        m, s, w = mo[1:], so[1:], wo[1:]
        out.append((mo[:3], so[:3], wo[:3]))
    return out, layout


def _own(a, layout, dim=0):
    return frame.own_rows(a, H, N_BANDS, layout, dim)


def _bits(a):
    return a.contiguous().view(torch.int32)


def test_local_bands_frame1_matches_unsharded_to_the_bit(band_frames):
    frames, layout = band_frames
    (m_u8, m_r, m_d), (s_u8, s_r, s_d), _ = frames[0]
    assert s_u8.shape == m_u8.shape == (H, W, 3)
    assert torch.equal(s_u8, m_u8)
    assert torch.equal(_bits(_own(s_d.slow, layout)), _bits(m_d.slow))
    assert torch.equal(_bits(_own(s_r.data, layout, 1)), _bits(m_r.data))


def _deviation(mono, bands, layout):
    """u8 mean |Δ|, shares within 1/255 and 3/255, own-row slow values
    within JAX's tolerances (rtol 1e-4, atol 1e-5), own-row slow and
    reservoir values that differ in a bit."""
    (m_u8, m_r, m_d), (s_u8, s_r, s_d) = mono, bands
    d = (s_u8.int() - m_u8.int()).abs()
    dmax = d.max(dim=-1).values
    slow = _own(s_d.slow, layout)
    ok = ((slow - m_d.slow).abs() <= 1e-5 + 1e-4 * m_d.slow.abs()).all(-1)
    return dict(mean=float(d.float().mean()),
                within1=float((dmax <= 1).float().mean()),
                within3=float((dmax <= 3).float().mean()),
                slow_in_tol=float(ok.float().mean()),
                slow_bits=int((_bits(slow) != _bits(m_d.slow)).sum()),
                restir_bits=int((_bits(_own(s_r.data, layout, 1))
                                 != _bits(m_r.data)).sum()),
                pixels=int((d > 0).any(-1).sum()))


def test_local_bands_frame2_against_unsharded(band_frames):
    """The camera still: every reservoir plane's own rows to the bit, the
    rest at bars set from the readings (u8 mean |Δ| 0.0125, 99.73% of
    pixels within 1/255, 99.32% of own-row slow values within JAX's
    tolerance; the 1080p bars of chip_smoke.BAND_BARS, but for slow: the
    8-row bands here lie wholly within the stencils' reach of an edge)."""
    frames, layout = band_frames
    dev = _deviation(*frames[1][:2], layout)
    print(f"frame 2: {dev}")
    assert dev["restir_bits"] == 0
    assert dev["mean"] <= 0.1
    assert dev["within1"] >= 0.99
    assert dev["slow_in_tol"] >= 0.985


def test_local_bands_frame3_deviation_is_the_band_motion_scaling(
        band_frames):
    """The camera moved: each band reprojects in its own rows (the
    reference caveat), and frame 3 is off JAX's tolerances on most
    own-row slow values (reading 36% within, u8 mean |Δ| 0.311, 98.3%
    within 3/255; held with room).  With the reprojection in image rows
    (the what-if), it holds JAX's tolerances on every own-row value and
    1/255 on every pixel."""
    frames, layout = band_frames
    mono, bands, what_if = frames[2]
    mirrored = _deviation(mono, bands, layout)
    fixed = _deviation(mono, what_if, layout)
    print(f"frame 3: mirrored {mirrored}, reprojection in image rows "
          f"{fixed}")
    assert mirrored["slow_in_tol"] < 0.5
    assert 0.0 < mirrored["mean"] <= 1.0 and mirrored["within3"] >= 0.95
    assert fixed["slow_in_tol"] == 1.0 and fixed["restir_bits"] == 0
    assert fixed["within1"] == 1.0


def test_local_bands_with_image_row_reprojection_frame2_to_the_bit(
        band_frames):
    """With the reprojection in image rows, frame 2 (camera still) equals
    the unsharded frame to the bit: u8, own-row slow history and every
    reservoir plane.  So frame 2's deviation is the band-local row
    coordinate's rounding, not the halo's history."""
    frames, layout = band_frames
    (m_u8, _, _), _, (w_u8, _, _) = frames[1]
    dev = _deviation(frames[1][0], frames[1][2], layout)
    assert torch.equal(w_u8, m_u8)
    assert dev["slow_bits"] == 0 and dev["restir_bits"] == 0


def test_band_reprojection_scales_v_motion_by_band_rows():
    """The reference caveat the port mirrors: on a band of ext rows, a
    v-motion of mv (in image units) moves ReSTIR's nearest tap by mv·ext
    rows, not mv·H.  Plane 5 (depth) holds each pixel's row index; the
    port's taps equal JAX's, and the source rows follow r - mv·ext."""
    ext, w, h_img = 34, 16, 64
    mv = 8.0 / h_img                         # 8 rows of the image
    data = np.zeros((8, ext, w), np.float32)
    data[5] = np.arange(ext, dtype=np.float32)[:, None]
    zero = np.zeros((ext, w), np.float32)
    mvs = np.full((ext, w), mv, np.float32)
    mine = restir_mod.warp_taps(
        restir_mod.ReSTIRState(data=torch.from_numpy(data)),
        torch.from_numpy(zero), torch.from_numpy(mvs), torch.tensor(0), 1)
    ref = jrestir.warp_taps(jrestir.ReSTIRState(data=jnp.asarray(data)),
                            jnp.asarray(zero), jnp.asarray(mvs),
                            jnp.uint32(0), 1)
    rows_mine = mine[0][0][5].numpy()
    np.testing.assert_array_equal(rows_mine, np.asarray(ref[0][0][5]))
    np.testing.assert_array_equal(mine[0][1].numpy(),
                                  np.asarray(ref[0][1]))
    r = np.arange(ext)
    src = np.floor(r - mv * ext + 0.5)       # 4.25 rows up, not 8
    valid = (src >= 0)
    np.testing.assert_array_equal(mine[0][1].numpy()[:, 0], valid)
    np.testing.assert_array_equal(rows_mine[valid, 0], src[valid])
    assert not np.any(rows_mine[valid, 0] == (r - 8)[valid])


# ---------------------------------------------------------------------------
# (e) the gloo dry run against LocalBands
# ---------------------------------------------------------------------------

def test_dryrun_multichip_gloo_equals_local_bands():
    n = 2
    got = dryrun_multichip(n, "cpu", timeout_s=RANKS_DEADLINE_S)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # as the ranks run
    try:
        eng = Engine(settings=dryrun_settings(), device="cpu")
        step, layout = frame.sharded_frame_fn(eng, n_devices=n)
        restir, dstate = frame.initial_sharded_state(eng, n)
        u8, restir, dstate = run_frames(eng, step, restir, dstate)
    finally:
        torch.set_num_threads(threads)
    assert got.layout == layout == (32, 58, 13)
    assert torch.equal(got.u8, u8)
    assert torch.equal(_bits(got.restir), _bits(restir.data))
    for a, b in zip(got.dstate, dstate):
        if a.dtype == torch.float32:
            a, b = _bits(a), _bits(b)
        assert torch.equal(a, b)


def test_run_ranks_kills_ranks_past_the_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        run_ranks(ranks.sleep_rank, 2, (60.0,), timeout_s=5.0)
    assert time.monotonic() - t0 < 40.0
