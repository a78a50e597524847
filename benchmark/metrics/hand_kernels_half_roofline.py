"""hand_kernels_half_roofline: hand_kernels_roofline in the cells at the
1/2 rung, whose rate is frame_ms.half: Σ bound / Σ device time of the
hand kernels a frame, in %."""
from rtvbbench.roofline import roofline_share


def read(run):
    if run.replay is None or run.extras is None:
        return None
    ms = sum(ms for ms, _ in run.replay["hand"].values())
    return roofline_share(sum(run.extras["bounds"].values()), ms)
