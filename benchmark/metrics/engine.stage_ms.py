"""engine.stage_ms: the mean ms of the program's span `engine.stage`
(Engine._stage: the per-frame inputs written through the pinned ring, its
wait included) over the window's frames before the profiled slice."""
from rtvbbench import program_trace


def read(run):
    return program_trace.span_ms(run, "engine.stage")
