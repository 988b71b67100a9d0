"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one command
runs one cell once (``python3 wolbench/run.py --workload <name> --seed
<n> --seconds <s> --trace <0|1>``), driven by ``BENCHMARK.json``."""
