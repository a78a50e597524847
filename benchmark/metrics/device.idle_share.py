"""device.idle_share: the share of a frame in which the device does
nothing, in %: 1 − (the union of device work's intervals a frame, in the
traced slice of replays) / (the mean frame interval of the window's
frames before the slice, which closes the window).  The slice's own
length is not the denominator: the tracer slows the host's replay calls
there, and the frames after a profile."""


def read(run):
    r = run.replay
    free = getattr(run.sess, "untraced", None)
    if r is None or not r["frames"] or not free:
        return None
    busy_s = r["busy_s"] / r["frames"]
    return 100.0 * (1.0 - busy_s / (sum(free) / len(free)))
