"""Window-kernel path: the CUDA kernel, its wrapper and plain version
(:mod:`~repro_torch.kernels.tap_window`), the step runner
(:mod:`~repro_torch.kernels.polyphase`), the single-level entry
(:mod:`~repro_torch.kernels.ops`) with the per-scheme drivers
(``sep_conv``, ``sep_lifting``, ``ns_conv``, ``ns_lifting``,
``ns_polyconv``) and the filter-bank oracle
(:mod:`~repro_torch.kernels.ref`).  Importing this package builds
nothing: the kernel is compiled at its first launch on a CUDA tensor."""
