"""Cross-device pieces of the port: the tile mesh of the tiling slice's
``"dist"`` transport (:mod:`repro_torch.distributed.sharding`)."""
