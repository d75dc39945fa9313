from repro_torch.configs.alphafold import (  # noqa: F401
    FULL, MINI, SMOKE, AlphaFoldConfig, EvoformerConfig, StructureConfig)
