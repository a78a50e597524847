"""The card's peaks and a kernel's least time (chip_smoke.py's bound_ms,
copied).

The least time the card could take for a kernel's work is its bytes
(each input read once, each output written once) over the memory rate,
or its operations over the f32 rate outside the tensor cores, whichever
is larger (NVIDIA H100 SXM data sheet, at its 700 W limit).  The f32
rate of 67 T/s counts an FMA as two operations; every hand kernel builds
with --fmad=false, so each product and each sum issues on its own, at
half that rate.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_NON_FMA_OPS_PER_S = 33.5e12


def bound_ms(n_bytes: float, n_ops: float) -> float:
    """The least ms of a kernel's work."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_NON_FMA_OPS_PER_S) \
        * 1e3


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def roofline_share(bounds_ms_per_frame: float,
                   device_ms_per_frame: float):
    """Σ bound / Σ device time, in %; None where nothing ran."""
    if not device_ms_per_frame or bounds_ms_per_frame is None:
        return None
    return 100.0 * bounds_ms_per_frame / device_ms_per_frame
