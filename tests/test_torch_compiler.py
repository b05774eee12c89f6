"""Port parity of the scheme algebra and the tap-program compiler.

The PyTorch port (``repro_torch``) keeps its own copies of the
framework-free modules; these tests hold them to the reference package
node for node: the StepSpec sequences, every compiled ``TapProgram``
(converted with ``tap_program_from_fields``), ``program_stats``, the
Table-1 op counts and the conv composition used as the library yardstick.
"""
import itertools

import numpy as np
import pytest

from repro import compiler as JC
from repro.compiler import conv as JCV
from repro.core import optimize as JO
from repro.core.schemes import SCHEMES
from repro.engine.plan import scheme_steps as j_scheme_steps

from repro_torch import compiler as TC
from repro_torch.compiler import conv as TCV
from repro_torch.convert import tap_program_from_fields
from repro_torch.core import optimize as TO
from repro_torch.kernels.polyphase import scheme_steps as t_scheme_steps

WAVELETS = ("cdf53", "cdf97", "dd137")
COMBOS = list(itertools.product((False, True), (False, True),
                                ("off", "exact", "full"), ("none", "scheme")))


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("wavelet", WAVELETS)
def test_programs_equal_reference_node_for_node(wavelet, scheme):
    for optimize, inverse, opt, fuse in COMBOS:
        ref = JC.compile_scheme_programs(wavelet, scheme, optimize, inverse,
                                         opt, fuse)
        got = TC.compile_scheme_programs(wavelet, scheme, optimize, inverse,
                                         opt, fuse)
        assert len(got) == len(ref)
        for r, g in zip(ref, got):
            conv = tap_program_from_fields(r)
            assert conv.nodes == g.nodes, (optimize, inverse, opt, fuse)
            assert conv.outputs == g.outputs
            assert r.halo == g.halo and r.stats() == g.stats()
        assert JC.program_stats(ref) == TC.program_stats(got)


@pytest.mark.parametrize("inverse", (False, True))
@pytest.mark.parametrize("optimize", (False, True))
@pytest.mark.parametrize("wavelet", WAVELETS)
def test_step_specs_equal_reference(wavelet, optimize, inverse):
    for scheme in SCHEMES:
        ref = j_scheme_steps(wavelet, scheme, optimize, inverse)
        got = t_scheme_steps(wavelet, scheme, optimize, inverse)
        assert len(ref) == len(got)
        for r, g in zip(ref, got):
            assert (r.pre, r.main, r.post) == (g.pre, g.main, g.post)
            assert r.halo == g.halo


@pytest.mark.parametrize("scheme", SCHEMES)
def test_table1_op_counts_equal_reference(scheme):
    for wavelet in WAVELETS:
        assert TO.table1_ops(wavelet, scheme) == \
            JO.table1_ops(wavelet, scheme)


@pytest.mark.parametrize("fuse", ("none", "scheme"))
def test_conv_composition_equals_reference(fuse):
    """The float64 filter bank behind the chip script's F.conv2d
    yardstick composes to exactly the reference's."""
    for wavelet, scheme in itertools.product(WAVELETS, SCHEMES):
        ref = JC.compile_scheme_programs(wavelet, scheme, False, False,
                                         "full", fuse)
        got = TC.compile_scheme_programs(wavelet, scheme, False, False,
                                         "full", fuse)
        for r, g in zip(ref, got):
            a = JCV.lower_program_to_conv(r)
            b = TCV.lower_program_to_conv(g)
            assert a.pad == b.pad and a.taps == b.taps
            np.testing.assert_array_equal(a.weights, b.weights)


def test_compile_steps_rejects_unknown_level():
    steps = t_scheme_steps("cdf53", "ns-conv", False, False)
    with pytest.raises(ValueError, match="unknown opt level"):
        TC.compile_steps(steps, "fast")
