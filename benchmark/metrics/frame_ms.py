"""frame_ms: the window's milliseconds over the frames completed in it
(host clock; every frame counts, those that carry an edit too)."""
from rtvbbench.stats import window_rate_ms


def read(run):
    s = run.sess
    return window_rate_ms(s.window[1] - s.window[0], len(s.window_frames()))
