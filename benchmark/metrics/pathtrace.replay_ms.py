"""pathtrace.replay_ms: the mean device ms between the program's stamps
before and after the path trace (`rtvb.pathtrace`), recorded by every
replay, over the window's frames before the profiled slice."""
from rtvbbench import program_trace


def read(run):
    return program_trace.device_ms(run, "pathtrace")
