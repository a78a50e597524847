"""frame_ms_p95: the 95th percentile of every frame interval of the
window, one frame's synchronize to the next one's (host clock)."""
from rtvbbench.stats import percentile


def read(run):
    return percentile(run.sess.intervals, 95) * 1e3
