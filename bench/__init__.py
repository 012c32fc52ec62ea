"""Benchmark of the PyTorch port (``repro_torch``): one command per run,
``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``.
See ``bench/README.md``."""
