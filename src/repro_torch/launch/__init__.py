"""The launch tooling of the port: the production and debug meshes
(:mod:`~repro_torch.launch.mesh`), meta-device input specs
(:mod:`~repro_torch.launch.specs`), FLOP and collective counting
(:mod:`~repro_torch.launch.analysis`) and the multi-pod dry run
(:mod:`~repro_torch.launch.dryrun`).  Importing any of them starts no
process group and sets no environment variable."""
