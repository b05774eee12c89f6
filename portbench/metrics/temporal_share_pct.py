"""``temporal_share_pct``: the share of the round trip's device time
(operations launched inside ``portbench.forward`` and
``portbench.inverse``) spent in the 3-D transform's temporal pass: its
periodic shifts (``torch.roll``) and the elementwise adds and multiplies
of its lifting steps and scaling, which nothing else on that path
launches (device trace).  The pass's interleave of the two half-bands
is a stack, whose copy kernel the 2-D levels' merges share, so it is
not counted: the share is a lower bound until the program has a span
around the pass."""

#: substrings of the names of the pass's own kernels
KERNELS = ("roll_cuda_kernel", "CUDAFunctor_add", "MulFunctor")
SPANS = ("portbench.forward", "portbench.inverse")


def read(reading):
    s = reading.summary
    if s is None:
        return None
    total = temporal = 0.0
    for span in SPANS:
        for name, sec in s.spans.get(span, (0, {}))[1].items():
            total += sec
            if any(k in name for k in KERNELS):
                temporal += sec
    if total <= 0 or temporal <= 0:
        return None
    return 100.0 * temporal / total
