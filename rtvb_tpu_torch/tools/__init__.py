"""Profiling tools of the port, the counterparts of the JAX package's
`tools/` profilers under the same file names:

    python -m rtvb_tpu_torch.tools.device_trace   # by kernel, op, function
    python -m rtvb_tpu_torch.tools.profile_frame  # each stage's four times
    python -m rtvb_tpu_torch.tools.ablate_pt      # path-trace variants
    python -m rtvb_tpu_torch.tools.micro_pt       # path tracer's pieces
    python -m rtvb_tpu_torch.tools.micro_post     # post's pieces

Each is a `main(argv)` around a function that returns a dict and takes
`device` ("cuda" by default; "cpu" runs the plain versions and reports
host-clock times, never under a device metric's name).  `timing` holds
what they share with chip_smoke.py.  Importing a module here starts no
work and touches no card.
"""
