"""The benchmark of esp32_opus_player_tpu_torch (the PyTorch and CUDA
port): `python -m bench_port --workload NAME --seed N --seconds S
--trace 0|1` runs one cell of BENCHMARK.json once. See bench_port/run.py.

fixtures/ holds frozen copies of tests/fixtures/<name>.opus, the sources
the configurations name; reference/ a frozen copy of the port's scalar
decoder (its own docstring says which files).
"""
