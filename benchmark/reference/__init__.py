"""The benchmark's frozen reference: a copy of the port's plain PyTorch
path (SOURCE.md says from which commit and how), with a kernel launcher
that sends every hand kernel to its plain version.  The output check
renders the same frames with it and compares.  It imports nothing of the
port and nothing of JAX."""
