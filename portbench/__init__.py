"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``): one cell
(a configuration under a traffic mix, named in ``BENCHMARK.json``) run
once by ``python portbench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``. See ``README.md``."""
