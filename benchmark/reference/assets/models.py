"""Model loading: OBJ and glTF 2.0 (.gltf / .glb) → MeshData (port of
rtvb_tpu/assets/models.py).

Dependency-free: OBJ is a line parser; glTF is JSON plus binary buffers
decoded with numpy (accessor / bufferView traversal).  Skins become a
Skeleton with its inverse binds; animations are resampled to uniform
tracks (models/animation.py) at load.
"""
from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from ..models.animation import AnimationClip
from ..models.entity import MeshData
from ..models.skeleton import Skeleton

_COMP_DTYPE = {5120: np.int8, 5121: np.uint8, 5122: np.int16,
               5123: np.uint16, 5125: np.uint32, 5126: np.float32}
_TYPE_SIZE = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


# ---------------------------------------------------------------------------
# OBJ
# ---------------------------------------------------------------------------

def load_obj(path: str) -> MeshData:
    vs, vns, vts = [], [], []
    out_pos, out_norm, out_uv, tris = [], [], [], []
    cache = {}

    def corner(spec: str) -> int:
        if spec in cache:
            return cache[spec]
        parts = (spec.split("/") + ["", ""])[:3]
        vi = int(parts[0]) - 1
        ti = int(parts[1]) - 1 if parts[1] else -1
        ni = int(parts[2]) - 1 if parts[2] else -1
        out_pos.append(vs[vi])
        out_uv.append(vts[ti] if ti >= 0 else (0.0, 0.0))
        out_norm.append(vns[ni] if ni >= 0 else (0.0, 1.0, 0.0))
        cache[spec] = len(out_pos) - 1
        return cache[spec]

    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                vs.append(tuple(float(x) for x in t[1:4]))
            elif t[0] == "vn":
                vns.append(tuple(float(x) for x in t[1:4]))
            elif t[0] == "vt":
                vts.append(tuple(float(x) for x in t[1:3]))
            elif t[0] == "f":
                ids = [corner(s) for s in t[1:]]
                for k in range(1, len(ids) - 1):   # fan triangulation
                    tris.append((ids[0], ids[k], ids[k + 1]))

    mesh = MeshData(
        positions=np.array(out_pos, np.float32),
        normals=np.array(out_norm, np.float32),
        uvs=np.array(out_uv, np.float32),
        indices=np.array(tris, np.int32),
    )
    if not len(vns):
        _recompute_normals(mesh)
    return mesh


def _recompute_normals(mesh: MeshData):
    n = np.zeros_like(mesh.positions)
    p = mesh.positions
    for a, b, c in mesh.indices:
        fn = np.cross(p[b] - p[a], p[c] - p[a])
        n[a] += fn
        n[b] += fn
        n[c] += fn
    mesh.normals = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-8)


# ---------------------------------------------------------------------------
# glTF 2.0
# ---------------------------------------------------------------------------

class _Gltf:
    def __init__(self, doc: dict, buffers: list):
        self.doc = doc
        self.buffers = buffers

    def accessor(self, idx: int) -> np.ndarray:
        acc = self.doc["accessors"][idx]
        view = self.doc["bufferViews"][acc["bufferView"]]
        buf = self.buffers[view["buffer"]]
        dtype = _COMP_DTYPE[acc["componentType"]]
        ncomp = _TYPE_SIZE[acc["type"]]
        offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        count = acc["count"]
        stride = view.get("byteStride")
        itemsize = np.dtype(dtype).itemsize * ncomp
        if stride and stride != itemsize:
            rows = [np.frombuffer(buf, dtype, ncomp, offset + i * stride)
                    for i in range(count)]
            data = np.stack(rows)
        else:
            data = np.frombuffer(buf, dtype, count * ncomp, offset)
            data = data.reshape(count, ncomp) if ncomp > 1 else data
        if acc.get("normalized"):
            data = data.astype(np.float32) / np.iinfo(dtype).max
        return np.array(data)


def _read_gltf(path: str) -> _Gltf:
    if path.endswith(".glb"):
        with open(path, "rb") as f:
            magic, _ver, _len = struct.unpack("<III", f.read(12))
            assert magic == 0x46546C67, "not a GLB file"
            doc = None
            buffers = []
            while True:
                head = f.read(8)
                if len(head) < 8:
                    break
                clen, ctype = struct.unpack("<II", head)
                data = f.read(clen)
                if ctype == 0x4E4F534A:          # JSON
                    doc = json.loads(data)
                elif ctype == 0x004E4942:        # BIN
                    buffers.append(data)
        return _Gltf(doc, buffers)

    with open(path) as f:
        doc = json.load(f)
    buffers = []
    for b in doc.get("buffers", []):
        uri = b["uri"]
        if uri.startswith("data:"):
            buffers.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(os.path.dirname(path), uri), "rb") as bf:
                buffers.append(bf.read())
    return _Gltf(doc, buffers)


def load_gltf(path: str) -> MeshData:
    """Loads the first skinned (or plain) mesh + skeleton + all animations."""
    g = _read_gltf(path)
    doc = g.doc

    mesh_idx, skin_idx = None, None
    for node in doc.get("nodes", []):
        if "mesh" in node:
            mesh_idx = node["mesh"]
            skin_idx = node.get("skin")
            break
    assert mesh_idx is not None, "no mesh in gltf"

    prim = doc["meshes"][mesh_idx]["primitives"][0]
    attrs = prim["attributes"]
    pos = g.accessor(attrs["POSITION"]).astype(np.float32)
    norm = (g.accessor(attrs["NORMAL"]).astype(np.float32)
            if "NORMAL" in attrs else None)
    uv = (g.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
          if "TEXCOORD_0" in attrs else np.zeros((len(pos), 2), np.float32))
    idx = g.accessor(prim["indices"]).astype(np.int32).reshape(-1, 3)

    joints = weights = skeleton = None
    node_to_joint = {}
    if skin_idx is not None and "JOINTS_0" in attrs:
        joints = g.accessor(attrs["JOINTS_0"]).astype(np.int32)
        weights = g.accessor(attrs["WEIGHTS_0"]).astype(np.float32)
        skin = doc["skins"][skin_idx]
        jnodes = skin["joints"]
        node_to_joint = {n: i for i, n in enumerate(jnodes)}
        inv_bind = g.accessor(skin["inverseBindMatrices"]).reshape(-1, 4, 4)
        inv_bind = inv_bind.transpose(0, 2, 1)    # gltf is column-major
        names, parents = [], []
        bt = np.zeros((len(jnodes), 3), np.float32)
        br = np.tile(np.array([[0, 0, 0, 1.0]], np.float32), (len(jnodes), 1))
        bs = np.ones((len(jnodes), 3), np.float32)
        for i, n in enumerate(jnodes):
            node = doc["nodes"][n]
            names.append(node.get("name", f"joint{i}"))
            parent = -1
            for pi, pn in enumerate(jnodes):
                if n in doc["nodes"][pn].get("children", []):
                    parent = pi
                    break
            parents.append(parent)
            bt[i] = node.get("translation", [0, 0, 0])
            br[i] = node.get("rotation", [0, 0, 0, 1])
            bs[i] = node.get("scale", [1, 1, 1])
        skeleton = Skeleton(names, np.array(parents, np.int32),
                            bt, br, bs, inv_bind.astype(np.float32))

    mesh = MeshData(positions=pos, normals=norm if norm is not None else pos * 0,
                    uvs=uv, indices=idx, joints=joints, weights=weights,
                    skeleton=skeleton)
    if norm is None:
        _recompute_normals(mesh)

    # animations (their samplers resampled to uniform tracks)
    if skeleton is not None:
        for a_i, anim in enumerate(doc.get("animations", [])):
            name = anim.get("name", f"clip{a_i}")
            per_joint = {}
            duration = 0.0
            for ch in anim["channels"]:
                node = ch["target"]["node"]
                if node not in node_to_joint:
                    continue
                j = node_to_joint[node]
                samp = anim["samplers"][ch["sampler"]]
                times = g.accessor(samp["input"]).astype(np.float32).reshape(-1)
                vals = g.accessor(samp["output"]).astype(np.float32)
                if samp.get("interpolation") == "CUBICSPLINE":
                    vals = vals.reshape(len(times), 3, -1)[:, 1]   # value keys
                duration = max(duration, float(times[-1]))
                entry = per_joint.setdefault(j, {
                    "t": (times, np.tile(skeleton.bind_t[j], (len(times), 1))),
                    "r": (times, np.tile(skeleton.bind_r[j], (len(times), 1))),
                    "s": (times, np.tile(skeleton.bind_s[j], (len(times), 1))),
                })
                key = {"translation": "t", "rotation": "r", "scale": "s"}.get(
                    ch["target"]["path"])
                if key:
                    entry[key] = (times, vals.reshape(len(times), -1))
            tracks = {}
            for j, e in per_joint.items():
                # merge channels onto a common grid: use the densest times
                times = max((e["t"][0], e["r"][0], e["s"][0]), key=len)
                def resample(src_t, src_v, n_out):
                    out = np.stack([np.interp(times, src_t, src_v[:, k])
                                    for k in range(src_v.shape[1])], -1)
                    return out
                tt = resample(*e["t"], 3)
                rr = resample(*e["r"], 4)
                rr /= np.maximum(np.linalg.norm(rr, axis=-1, keepdims=True), 1e-8)
                ss = resample(*e["s"], 3)
                tracks[j] = (times, tt, rr, ss)
            if tracks and duration > 0:
                mesh.clips[name] = AnimationClip.from_keyframes(
                    name, tracks, skeleton.n_joints, duration)
    return mesh


def load_model(path: str) -> MeshData:
    """Load an OBJ or a glTF / GLB file by its extension."""
    if path.endswith(".obj"):
        return load_obj(path)
    if path.endswith((".gltf", ".glb")):
        return load_gltf(path)
    raise ValueError(f"unsupported model format: {path}")
