"""edit.soup_ms: the mean ms of the program's span `edit.soup` (the
soup's static rows rebuilt and written after an edit) over the window's
edits before the profiled slice."""
from rtvbbench import program_trace


def read(run):
    return program_trace.span_ms(run, "edit.soup")
