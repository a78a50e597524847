"""hand_kernels.device_ms: device ms a frame of the hand kernels (each
role in kernels/, by its device name) in the traced slice of replays."""


def read(run):
    if run.replay is None:
        return None
    return sum(ms for ms, _ in run.replay["hand"].values())
