"""edit_ms_p95: the 95th percentile, over every click due in the window,
of the ms from when it was due to the synchronize of the first frame
rendered after its calls returned (host clock)."""
from rtvbbench.stats import percentile


def read(run):
    clicks = run.sess.window_clicks()
    if not clicks:
        return None
    return percentile([c["seen"] - c["due"] for c in clicks], 95) * 1e3
