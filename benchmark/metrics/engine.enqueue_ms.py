"""engine.enqueue_ms: the mean ms from the call of
Engine.render_realtime_device to its return, over the window's frames
(the benchmark's host span)."""


def read(run):
    v = run.sess.spans.get("enqueue")
    return sum(v) / len(v) * 1e3 if v else None
