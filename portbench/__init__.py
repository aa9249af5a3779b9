"""The benchmark of the PyTorch and CUDA port (``kgcn_tpu_torch``): one
command runs one cell, ``python3 -m portbench.run --workload <cell> --seed
<n> --seconds <s> --trace <0|1>``, and prints one JSON line.  See
``run.py``."""
