"""graph.captures: new Engine.graph_log entries during the window (a
program counter; a replayed cell reads 0)."""


def read(run):
    return run.sess.counters.get("captures")
