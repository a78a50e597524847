"""engine.identity_ms: the mean ms of the program's span
`engine.identity` (frame_graph.identity over the graph's inputs and the key
lookup) over the window's frames before the profiled slice."""
from rtvbbench import program_trace


def read(run):
    return program_trace.span_ms(run, "engine.identity")
