"""cellbench: the benchmark of poisson_tpu_torch, the PyTorch and CUDA port.

Cells, configurations, traffic mixes, limits and metric readers are files
found by the names in ``BENCHMARK.json`` (:mod:`cellbench.spec`); one run
of one cell is ``python -m cellbench --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` (:mod:`cellbench.run`). Nothing here imports
JAX or the JAX package.
"""
