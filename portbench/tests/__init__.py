"""CPU tests of the benchmark (``python -m pytest portbench/tests``):
every cell end to end at a tiny size through the kernels' plain
versions, the reference, the controls and the planted faults, the trace
reduction and ``BENCHMARK.json``'s form."""
