"""device.gap_ms: the mean device ms from one frame's closing stamp (after
its state write-back) to the next frame's first (before its path trace):
the output's clone, the pack, the staging copy, clicks and every host
wait, over the window's frames before the profiled slice."""
from rtvbbench import program_trace


def read(run):
    return program_trace.gap_ms(run)
