"""torch_ops.device_ms: the device's busy ms a frame in the traced slice
of replays, less the hand kernels' device ms."""


def read(run):
    if run.replay is None:
        return None
    r = run.replay
    return r["busy_s"] * 1e3 / r["frames"] - sum(
        ms for ms, _ in r["hand"].values())
