"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one
NVIDIA H100: ``python3 portbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``, driven by ``BENCHMARK.json`` at the root
of the checkout (see :mod:`portbench.harness`)."""
