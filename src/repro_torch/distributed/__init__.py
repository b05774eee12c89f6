"""Cross-device pieces of the port: the tile mesh of the tiling slice's
``"dist"`` transport (:mod:`repro_torch.distributed.sharding`) and the
heartbeat tracker the serving runtime follows its workers with
(:mod:`repro_torch.distributed.fault_tolerance`)."""
