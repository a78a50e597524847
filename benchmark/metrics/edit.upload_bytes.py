"""edit.upload_bytes: the bytes copied to the device an edit, counted on
the program's spans `edit.upload` and `edit.soup`, over the window's edits
before the profiled slice."""
from rtvbbench import program_trace


def read(run):
    return program_trace.bytes_per(run, ("edit.upload", "edit.soup"),
                                   "edit.upload")
