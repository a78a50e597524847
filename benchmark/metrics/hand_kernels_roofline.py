"""hand_kernels_roofline: Σ bound / Σ device time of the hand kernels a
frame, in %: each launch's bound from its work (kernels/<role>.py) on
the calls of an eager frame after the window, the device time from the
traced slice of replays."""
from rtvbbench.roofline import roofline_share


def read(run):
    if run.replay is None or run.extras is None:
        return None
    ms = sum(ms for ms, _ in run.replay["hand"].values())
    return roofline_share(sum(run.extras["bounds"].values()), ms)
