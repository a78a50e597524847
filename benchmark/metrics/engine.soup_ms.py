"""engine.soup_ms: the mean ms of the program's span `engine.soup`
(Engine.entity_buffers: the soup's static rows and the entities' pack) over
the window's frames before the profiled slice."""
from rtvbbench import program_trace


def read(run):
    return program_trace.span_ms(run, "engine.soup")
