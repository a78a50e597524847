"""edit.upload_ms: the mean ms of the program's span `edit.upload` (the
rebuilt tables written in place or replaced, the remap uploaded) over the
window's edits before the profiled slice."""
from rtvbbench import program_trace


def read(run):
    return program_trace.span_ms(run, "edit.upload")
