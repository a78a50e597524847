"""edit.rebuild_ms: the mean of Engine.last_edit["host_ms"] (the host
rebuild of the tables) over the window's clicks that edited (a program
counter)."""


def read(run):
    c = [x["rebuild_ms"] for x in run.sess.window_clicks()
         if "rebuild_ms" in x
         and not x["profiled"]]
    return sum(c) / len(c) if c else None
