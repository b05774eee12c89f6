"""``plane_copy_gb``: the bytes the plane copies around K1 write per
request, in 1e9 bytes: the program's ``repro_plane_copy_bytes_total``
(split and merge) over its forward executions, one per request, across
the run (program counter)."""
from portbench import program


def read(reading):
    n = program.per_request("repro_plane_copy_bytes_total")
    return None if n is None else n / 1e9
