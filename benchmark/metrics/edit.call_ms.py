"""edit.call_ms: the mean ms from a click's first call (pick_block) to
the return of its last (set_block / delete_block) and a synchronize (the
upload complete), over the window's clicks outside the traced slice
(the benchmark's span)."""


def read(run):
    c = [x["call_s"] for x in run.sess.window_clicks() if "call_s" in x
         and not x["profiled"]]
    return sum(c) / len(c) * 1e3 if c else None
