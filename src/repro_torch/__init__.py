"""PyTorch/CUDA port of the FastFold AlphaFold system for NVIDIA Hopper.

A second package beside the JAX reference (``src/repro``). It imports
``torch`` and numpy only. Folding inference runs through
``repro_torch.exec.FastFold``; the LayerNorm, gating and flash-attention
forward run as hand-written CUDA kernels (``csrc/``), built with ``nvcc`` for
``sm_90a`` at first use. Entry points run on the card unless the caller
passes ``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version.
"""
