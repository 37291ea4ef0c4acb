"""The benchmark of the PyTorch and CUDA port (`garment_pattern_estimation_torch`).

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` on the cards of this machine and prints
its result as the last line of standard output (see `run.py`)."""
