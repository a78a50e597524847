"""Linear-blend skinning (port of rtvb_tpu/models/skinning.py): each
vertex's four joint matrices weighted, summed and applied."""
from __future__ import annotations

import torch


def _blended(joints, weights, joint_mats):
    """Each vertex's four joint matrices, weighted and summed: (N, 4, 4)."""
    m = joint_mats[joints.long()]                           # (N, 4, 4, 4)
    return (m * weights[..., None, None]).sum(dim=1)


def _apply(blended, positions):
    p = torch.cat([positions, torch.ones_like(positions[:, :1])], dim=-1)
    return torch.einsum("nij,nj->ni", blended, p)[:, :3]


def skin_positions(positions, joints, weights, joint_mats):
    """The skinned positions alone (N, 3): skin_vertices without the
    normals, which a triangle soup does not use (it takes geometric
    normals)."""
    return _apply(_blended(joints, weights, joint_mats), positions)


def skin_vertices(positions, normals, joints, weights, joint_mats):
    """positions (N, 3), normals (N, 3), joints (N, 4) int, weights (N, 4),
    joint_mats (J, 4, 4) → (skinned positions (N, 3), normals (N, 3))."""
    blended = _blended(joints, weights, joint_mats)
    sp = _apply(blended, positions)
    # normals: rotate by the 3×3 part (uniform-scale assumption)
    sn = torch.einsum("nij,nj->ni", blended[:, :3, :3], normals)
    sn = sn / torch.clamp(torch.linalg.vector_norm(sn, dim=-1, keepdim=True),
                          min=1e-8)
    return sp, sn
