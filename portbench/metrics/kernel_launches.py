"""``kernel_launches``: launches of the hand-written kernels (K1, K2,
K3) per request: the program's ``repro_kernel_launches_total`` over its
forward executions, one per request, across the run (program
counter)."""
from portbench import program


def read(reading):
    return program.per_request("repro_kernel_launches_total")
