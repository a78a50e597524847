"""torch_ops.kernels_per_frame: device kernels a frame in the traced
slice of replays, less the hand kernels' launches."""


def read(run):
    if run.replay is None:
        return None
    r = run.replay
    return r["kernels_per_frame"] - sum(n for _, n in r["hand"].values())
