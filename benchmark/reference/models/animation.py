"""Animation clips: keyframe sampling, blending, additive layers (port of
rtvb_tpu/models/animation.py).

Clips are resampled to a fixed rate at load time, so sampling is
arithmetic indexing.  Pose math runs per frame on the host in numpy (the
JAX package's host path): only the composed joint matrices cross to the
device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

RESAMPLE_HZ = 30.0


def _slerp(q0, q1, t):
    d = (q0 * q1).sum(-1, keepdims=True)
    q1 = np.where(d < 0, -q1, q1)
    d = np.abs(d)
    # nlerp fallback for near-parallel; slerp otherwise
    theta = np.arccos(np.clip(d, -1.0, 1.0))
    sin_t = np.sin(theta)
    use_slerp = sin_t > 1e-4
    w0 = np.where(use_slerp,
                  np.sin((1 - t) * theta) / np.maximum(sin_t, 1e-8), 1 - t)
    w1 = np.where(use_slerp, np.sin(t * theta) / np.maximum(sin_t, 1e-8), t)
    q = w0 * q0 + w1 * q1
    return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-8)


@dataclass
class AnimationClip:
    """Uniformly resampled joint tracks."""
    name: str
    t: np.ndarray      # (F, J, 3) translations
    r: np.ndarray      # (F, J, 4) rotations (xyzw, normalized)
    s: np.ndarray      # (F, J, 3) scales
    duration: float
    loop: bool = True

    @property
    def n_frames(self) -> int:
        return self.t.shape[0]

    @classmethod
    def from_keyframes(cls, name, times_trs, j, duration, loop=True,
                       rate=RESAMPLE_HZ, interpolation="LINEAR"):
        """times_trs: per-joint dict {joint: (times, t(K,3), r(K,4),
        s(K,3))}.  Resamples every channel to a uniform `rate`
        (STEP / LINEAR / CUBICSPLINE all collapse to dense keys;
        CUBICSPLINE input uses its value keys)."""
        f = max(2, int(round(duration * rate)) + 1)
        grid = np.linspace(0.0, duration, f)
        t = np.zeros((f, j, 3), np.float32)
        r = np.zeros((f, j, 4), np.float32)
        r[..., 3] = 1.0
        s = np.ones((f, j, 3), np.float32)
        for joint, (times, tt, rr, ss) in times_trs.items():
            times = np.asarray(times)
            if interpolation == "STEP":
                idx = np.clip(np.searchsorted(times, grid, "right") - 1, 0,
                              len(times) - 1)
                t[:, joint] = tt[idx]
                r[:, joint] = rr[idx]
                s[:, joint] = ss[idx]
            else:
                for k in range(3):
                    t[:, joint, k] = np.interp(grid, times, tt[:, k])
                    s[:, joint, k] = np.interp(grid, times, ss[:, k])
                # piecewise-linear quat then renormalize (nlerp resample)
                for k in range(4):
                    r[:, joint, k] = np.interp(grid, times, rr[:, k])
                n = np.linalg.norm(r[:, joint], axis=-1, keepdims=True)
                r[:, joint] /= np.maximum(n, 1e-8)
        return cls(name, t, r, s, duration, loop)

    def host_tracks(self):
        return self.t, self.r, self.s


def evaluate(clip_tracks, time, duration, loop=True):
    """Sample uniform host tracks at `time` → (J,3), (J,4), (J,3)."""
    t_arr, r_arr, s_arr = clip_tracks
    f = t_arr.shape[0]
    tt = np.asarray(time, np.float32)
    if loop:
        tt = np.mod(tt, duration)
    else:
        tt = np.clip(tt, 0.0, duration)
    x = tt / duration * (f - 1)
    i0 = np.clip(np.floor(x).astype(np.int32), 0, f - 2)
    w = (x - i0)[..., None, None]
    t = t_arr[i0] * (1 - w) + t_arr[i0 + 1] * w
    s = s_arr[i0] * (1 - w) + s_arr[i0 + 1] * w
    r = _slerp(r_arr[i0], r_arr[i0 + 1], w[..., 0])
    return t, r, s


def blend(pose_a, pose_b, alpha):
    """Two-clip blend."""
    ta, ra, sa = pose_a
    tb, rb, sb = pose_b
    return (ta * (1 - alpha) + tb * alpha,
            _slerp(ra, rb, np.asarray(alpha)[..., None]),
            sa * (1 - alpha) + sb * alpha)


def quat_mul(a, b):
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], axis=-1)


def additive(base_pose, add_pose, ref_pose, weight):
    """Additive layer: base ∘ (add − ref), scaled by weight."""
    tb, rb, sb = base_pose
    ta, ra, sa = add_pose
    tr, rr, sr = ref_pose
    t = tb + (ta - tr) * weight
    # delta rotation = add * inverse(ref)
    rr_inv = rr * np.asarray([-1.0, -1.0, -1.0, 1.0], np.float32)
    delta = quat_mul(ra, rr_inv)
    ident = np.zeros_like(delta)
    ident[..., 3] = 1.0
    delta_w = _slerp(ident, delta, np.asarray(weight)[..., None])
    r = quat_mul(delta_w, rb)
    s = sb * (1 + (sa - sr) * weight)
    return t, r, s
