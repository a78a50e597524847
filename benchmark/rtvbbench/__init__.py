"""The benchmark harness of rtvb_tpu_torch: a cell's set-up, its measured
window, its traced run and its output check, driven by the files of the
benchmark directory (BENCHMARK.json at the repository root, configs/,
traffic/, metrics/, kernels/, limits/)."""
