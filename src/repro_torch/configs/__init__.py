"""Architecture registry of the port: every arch of the reference (the dense
decoder-only archs, the MoE decoder, DeepSeek-V2-Lite, Mamba2, Jamba,
Llama-3.2-Vision and SeamlessM4T), full and smoke-reduced, plus the shape
definitions.
``get_config(name)`` / ``get_smoke(name)``."""

from repro_torch.configs.base import (SHAPES, ArchConfig, EncoderCfg, MlaCfg,
                                      MoeCfg, ShapeCfg, SsmCfg,
                                      applicable_shapes)
from repro_torch.configs.registry import (ARCHS, get_config, get_smoke,
                                          list_archs)

__all__ = ["SHAPES", "ArchConfig", "EncoderCfg", "MlaCfg", "MoeCfg",
           "ShapeCfg", "SsmCfg", "applicable_shapes", "ARCHS", "get_config",
           "get_smoke", "list_archs"]
