"""engine.launch_ms: the mean ms of the program's span `engine.launch`
(FrameGraph.replay and the output's clone) over the window's frames before
the profiled slice."""
from rtvbbench import program_trace


def read(run):
    return program_trace.span_ms(run, "engine.launch")
