"""edit.pick_ms: the mean ms of the program's span `edit.pick`
(Engine.pick_block, its read to the host included) over the window's clicks
before the profiled slice."""
from rtvbbench import program_trace


def read(run):
    return program_trace.span_ms(run, "edit.pick")
