"""Rays that probe K2's box cull where rounding could make it wrong, for
tests/test_torch_tri.py (the plain version against the JAX package) and
tests/test_torch_gpu.py (the kernel against the plain version).

`probe_rays(soup, seed)` builds, around the box of the soup's rows with a
nonzero e1 (the rows the sweep tests):
- rays in the planes of the padded box's faces (the kernel pads by 1e-3),
  parallel to the face, with an exactly zero or a tiny normal component;
- rays aimed at the unpadded box's corners, edge points and face points,
  and at points just inside and outside them (1e-5 to 2e-3);
- rays aimed at the triangles' vertices and edge midpoints (grazing hits);
- rays that start inside the box;
- rays with one or two exactly zero direction components;
- the path tracer's parked rays, o = (0, 1e4, 0), d = (0, 1, 0);
- rays aimed at triangle centroids, capped at the plain version's hit t,
  one float below it and one float above it (just short and just past).
Returns (o, d, cap) as float32 numpy arrays, cap 1e30 where uncapped.

`in_plane_rays(soup, seed)` builds rays that start in, or within a few
ulps of, the plane of each of the soup's triangles, 2 and 20 units from
it, and run in that plane: there Möller–Trumbore's determinant is mostly
rounding, and the plain version reports "hits" far from the triangle,
which a box cull padded by a fixed margin drops.  `in_plane_soup(seed)`
is such a soup: the row of PLANE_RAY's hit and tilted triangles with
edges 1.0 and 2.0.
"""
from __future__ import annotations

import numpy as np
import torch

BIG = np.float32(1e30)
PAD = np.float32(1e-3)


# a tilted triangle and a ray in its plane, in exact float32: the plain
# version reports a hit at t = 2.0, u = 0, v = 1, and the ray does not
# reach the triangle's box padded by 1e-3
PLANE_ROW = np.array([25.81646728515625, 33.664222717285156,
                      13.96352481842041, 0.0, -1.7159966230392456,
                      1.027305006980896, -1.8524398803710938,
                      -0.12752188742160797, 0.9550940990447998], np.float32)
PLANE_RAY = (np.array([24.085620880126953, 32.62156677246094,
                       15.408795356750488], np.float32),
             np.array([-0.5345049500465393, 0.812460720539093,
                       -0.23283487558364868], np.float32))


def soup_box(soup):
    """(lo, hi) of the points v0, v0 + e1, v0 + e2 of the rows with a
    nonzero e1, in float32; a box at the world's centre for a soup of
    padding."""
    soup = np.asarray(soup, np.float32)
    live = np.any(soup[:, 3:6] != 0, axis=1)
    if not live.any():
        return (np.array([28, 8, 28], np.float32),
                np.array([36, 12, 36], np.float32))
    v0 = soup[live, 0:3]
    pts = np.concatenate([v0, v0 + soup[live, 3:6], v0 + soup[live, 6:9]])
    return pts.min(0), pts.max(0)


def random_soup(n, seed, lo=(10, 4, 10), hi=(54, 20, 54), size=2.0):
    """n random triangles packed as [v0 | e1 | e2], float32."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    e1 = rng.normal(0, size, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, size, (n, 3)).astype(np.float32)
    return np.concatenate([v0, e1, e2], axis=1).astype(np.float32)


def tilted_soup(n, edge, seed):
    """n triangles with both edges `edge` long in random directions (so
    their planes are tilted against every axis), packed as [v0 | e1 | e2]."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform([10, 4, 10], [54, 20, 54], (n, 3))
    e1 = _unit(rng.normal(size=(n, 3))) * edge
    e2 = _unit(rng.normal(size=(n, 3))) * edge
    return np.concatenate([v0, e1, e2], axis=1).astype(np.float32)


def in_plane_soup(seed=0):
    """PLANE_ROW, 8 tilted triangles with edges 1.0 and 8 with edges 2.0,
    each followed by 3 rows of padding: a lone triangle under each of
    K2's 4-row cluster boxes, whose box is then the triangle's own."""
    rows = np.concatenate([PLANE_ROW[None], tilted_soup(8, 1.0, seed),
                           tilted_soup(8, 2.0, seed + 1)])
    out = np.zeros((4 * len(rows), 9), np.float32)
    out[::4] = rows
    return out


def _ulps(rng, x, k=2):
    """x moved by up to k float32 ulps in each coordinate."""
    step = rng.integers(-k, k + 1, x.shape).astype(np.float32)
    return (x + step * np.spacing(np.abs(x))).astype(np.float32)


def in_plane_rays(soup, seed: int = 0, n: int = 300, dists=(2.0, 20.0)):
    """For each live row and each distance r: n rays from points of the
    row's plane up to r from its centroid, in directions of that plane
    (origins and directions then moved by up to 2 ulps), and PLANE_RAY.
    Returns (o, d) as tuples of float32 numpy arrays."""
    soup = np.asarray(soup, np.float32)
    rng = np.random.default_rng(seed)
    os_, ds = [PLANE_RAY[0][None]], [PLANE_RAY[1][None]]
    for row in soup[np.any(soup[:, 3:6] != 0, axis=1)].astype(np.float64):
        v0, e1, e2 = row[0:3], row[3:6], row[6:9]
        centre = v0 + (e1 + e2) / 3.0
        for r in dists:
            a = rng.normal(size=(n, 2))
            a = _unit(a[:, :1] * e1 + a[:, 1:] * e2)
            o = centre + rng.uniform(0.0, r, (n, 1)) * a
            w = rng.normal(size=(n, 2))
            w = _unit(w[:, :1] * e1 + w[:, 1:] * e2)
            os_.append(_ulps(rng, o.astype(np.float32)))
            ds.append(_ulps(rng, w.astype(np.float32)))
    o = np.concatenate(os_).astype(np.float32)
    d = np.concatenate(ds).astype(np.float32)
    return (tuple(o[:, i].copy() for i in range(3)),
            tuple(d[:, i].copy() for i in range(3)))


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _aim(rng, targets, dist=(5.0, 30.0)):
    """Rays from random points around `targets` toward them."""
    d = _unit(rng.normal(size=targets.shape))
    o = targets - d * rng.uniform(*dist, (len(targets), 1))
    return o, _unit(targets - o)


def probe_rays(soup, seed: int = 0, n: int = 256):
    soup = np.asarray(soup, np.float32)
    rng = np.random.default_rng(seed)
    lo, hi = soup_box(soup)
    lo_p, hi_p = lo - PAD, hi + PAD
    os_, ds = [], []

    # in the padded box's face planes, parallel to the face
    for a in range(3):
        for face in (lo_p[a], hi_p[a]):
            o = rng.uniform(lo_p - 2, hi_p + 2, (n, 3))
            o[:, a] = face
            d = rng.normal(size=(n, 3))
            d[:, a] = 0.0
            d = _unit(d)
            d[n // 2:, a] = rng.choice([1e-13, -1e-13, 1e-8, -1e-8],
                                       n - n // 2)
            os_.append(o)
            ds.append(d)

    # at the unpadded box's corners, edges and faces, and just off them
    corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                        for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
    t = rng.choice(corners, n)
    edge = rng.uniform(lo, hi, (n, 3))
    for i in range(n):
        a, b = rng.choice(3, 2, replace=False)
        edge[i, a] = (lo if rng.random() < 0.5 else hi)[a]
        edge[i, b] = (lo if rng.random() < 0.5 else hi)[b]
    face = rng.uniform(lo, hi, (n, 3))
    axis = rng.integers(0, 3, n)
    side = rng.random(n) < 0.5
    face[np.arange(n), axis] = np.where(side, lo[axis], hi[axis])
    for targets in (t, edge, face):
        for off in (0.0, 1e-5, -1e-5, 5e-4, 1e-3, -1e-3, 2e-3):
            centre = (lo + hi) / 2
            out = np.sign(targets - centre) * off
            o, d = _aim(rng, targets + out)
            os_.append(o)
            ds.append(d)

    # at the triangles' vertices and edge midpoints
    live = soup[np.any(soup[:, 3:6] != 0, axis=1)]
    if len(live):
        v0, e1, e2 = live[:, 0:3], live[:, 3:6], live[:, 6:9]
        pts = np.concatenate([v0, v0 + e1, v0 + e2, v0 + 0.5 * e1,
                              v0 + 0.5 * e2, v0 + 0.5 * (e1 + e2)])
        o, d = _aim(rng, pts[rng.integers(0, len(pts), 4 * n)])
        os_.append(o)
        ds.append(d)

    # starting inside the box
    os_.append(rng.uniform(lo, hi, (n, 3)))
    ds.append(_unit(rng.normal(size=(n, 3))))

    # one or two zero direction components, around and inside the box
    for zero in ([0], [1], [2], [0, 2], [0, 1], [1, 2]):
        o = rng.uniform(lo - 3, hi + 3, (n, 3))
        d = rng.normal(size=(n, 3))
        d[:, zero] = 0.0
        os_.append(o)
        ds.append(_unit(d))

    # the path tracer's parked rays
    os_.append(np.tile([0.0, 1e4, 0.0], (n // 4, 1)))
    ds.append(np.tile([0.0, 1.0, 0.0], (n // 4, 1)))

    o = np.concatenate(os_).astype(np.float32)
    d = np.concatenate(ds).astype(np.float32)
    # caps: none on a third, random on a third, a short one on the rest
    cap = np.full(len(o), BIG, np.float32)
    k = len(o) // 3
    cap[k:2 * k] = rng.uniform(0.5, 60.0, k)
    cap[2 * k:] = rng.uniform(0.0, 2e-3, len(o) - 2 * k)

    # at triangle centroids, capped at, below and above the hit t
    if len(live):
        c = v0 + (e1 + e2) / 3.0
        co, cd = _aim(rng, c[rng.integers(0, len(c), n)])
        co, cd = co.astype(np.float32), cd.astype(np.float32)
        T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
        from rtvb_tpu_torch.ops import triangles
        th = triangles.intersect_packed_plain(
            tuple(T(co[:, i]) for i in range(3)),
            tuple(T(cd[:, i]) for i in range(3)), T(soup))
        th_t = th.t.numpy()
        hit = th.hit.numpy()
        co, cd, th_t = co[hit], cd[hit], th_t[hit]
        caps = [th_t, np.nextafter(th_t, np.float32(np.inf)),
                np.nextafter(th_t, np.float32(0))]
        o = np.concatenate([o] + [co] * 3)
        d = np.concatenate([d] + [cd] * 3)
        cap = np.concatenate([cap] + caps).astype(np.float32)
    return ((o[:, 0].copy(), o[:, 1].copy(), o[:, 2].copy()),
            (d[:, 0].copy(), d[:, 1].copy(), d[:, 2].copy()), cap)
