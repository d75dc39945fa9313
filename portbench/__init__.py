"""The benchmark of the PyTorch/H100 port (``repro_torch``): one command
runs one cell once (``python portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``). Cells, configurations, traffic kinds,
kernels and per-layer metrics are files found by name."""
