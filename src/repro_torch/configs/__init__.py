from repro_torch.configs.base import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                      ModelConfig, PREFILL_32K, RunConfig,
                                      ShapeConfig, TRAIN_4K)
from repro_torch.configs.registry import (ARCH_IDS, all_cells,
                                          get_config, shape_applicability)
