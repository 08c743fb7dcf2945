"""The benchmark of the PyTorch/CUDA port of DBL (``repro_torch``): one
cell a run, ``python3 -m reachbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.  See ``run.py``."""
