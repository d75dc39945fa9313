"""PyTorch/CUDA port of the FastFold AlphaFold system for NVIDIA Hopper.

A second package beside the JAX reference (``src/repro``). It imports
``torch`` and numpy only. Folding inference and the training loss run
through ``repro_torch.exec.FastFold``, a training step through
``repro_torch.train.make_train_step(FastFold(...).loss_fn)``. Every TPU
kernel on those paths (LayerNorm, gating, bias-dropout-add, flash-attention
forward and backward, the fused triangle update and outer-product-mean) is
a hand-written CUDA kernel (``csrc/``), built with ``nvcc`` for ``sm_90a`` at
first use. Entry points run on the card unless the caller passes
``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version.
"""
