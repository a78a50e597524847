"""denoise.device_ms: device ms a frame of the work launched under the
`rtvb.denoise` range, from the eager frames profiled after the window
(attribution by correlation id)."""


def read(run):
    if run.extras is None:
        return None
    return run.extras["stages"].get("rtvb.denoise")
