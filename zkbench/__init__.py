"""The benchmark of the PyTorch and CUDA port (`uzkge_tpu_torch`): one run
of one cell of `BENCHMARK.json` per process (`python3 zkbench/run.py`)."""
