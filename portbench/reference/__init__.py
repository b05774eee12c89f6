"""Plain references of the transforms the benchmark drives, one module
per wavelet, found by the configuration's ``wavelet``.

``portbench/reference/<wavelet>.py`` gives ``dwt2``/``idwt2`` and
``dwt3``/``idwt3`` in plain PyTorch, computed in float64 (a ``dtype``
argument sets another precision, for the check's control) one block
at a time.  :mod:`portbench.reference.cdf97` is CDF 9/7 written from
its lifting steps on a periodic boundary.  A reference imports nothing
of the program under test and takes nothing the program made: it reads
the benchmark's own inputs, and the program's outputs only to judge
them (:mod:`portbench.check`).
"""
import importlib


def load(wavelet: str):
    """The reference module of ``wavelet``."""
    return importlib.import_module(f"portbench.reference.{wavelet}")
