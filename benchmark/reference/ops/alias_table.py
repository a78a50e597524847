"""Alias tables: O(1) categorical sampling (port of
rtvb_tpu/ops/alias_table.py).  The build is exact Vose/Walker on the host
in numpy; sampling is two indexed reads + a compare."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class AliasTable(NamedTuple):
    prob: np.ndarray     # (N,) f32 acceptance probability of own column
    alias: np.ndarray    # (N,) i32 alias index
    pmf: np.ndarray      # (N,) f32 normalized probability mass


def build(weights) -> AliasTable:
    """Exact Vose alias-table construction (host-side numpy, O(n))."""
    w = np.maximum(np.asarray(weights, np.float64), 0.0)
    n = len(w)
    total = w.sum()
    if total <= 0.0 or n == 0:
        n = max(n, 1)
        return AliasTable(prob=np.ones((n,), np.float32),
                          alias=np.arange(n, dtype=np.int32),
                          pmf=np.full((n,), 1.0 / n, np.float32))
    pmf = w / total
    scaled = pmf * n
    prob = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int32)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] - (1.0 - scaled[s])
        if scaled[l] < 1.0:
            small.append(l)
        else:
            large.append(l)
    for i in small + large:
        prob[i] = 1.0
        alias[i] = i
    return AliasTable(prob=prob.astype(np.float32), alias=alias,
                      pmf=pmf.astype(np.float32))


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[clip(idx)] — the JAX package's fast_gather semantics."""
    n = table.shape[0]
    return table[torch.clamp(idx, 0, n - 1).long()]


def sample(prob, alias, pmf, u):
    """Draw indices: u uniform in [0,1).  Returns (index, pmf[index])."""
    n = prob.shape[0]
    un = u * n
    col = torch.clamp(un.to(torch.int32), 0, n - 1)
    frac = un - col.to(torch.float32)
    idx = torch.where(frac < take(prob, col), col, take(alias, col))
    return idx, take(pmf, idx)
