"""Where the port runs: the card unless the caller asks for the CPU, the
device memory a fold may plan against there, and the card's published
peaks."""
from __future__ import annotations

import torch

# Published peaks of the card the port targets, one NVIDIA H100 80GB HBM3
# (SXM; NVIDIA's data sheet, dense rates, at the card's full power limit of
# 700 W; a card set below it reaches less). Roofline floors read them here.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 on the tensor cores
PEAK_FLOPS_FP32 = 67e12         # FLOP/s, fp32 outside the tensor cores
HBM_BW = 3.35e12                # bytes/s

# The budget AutoChunk plans against for a fold on the CPU, where no device
# memory bounds it: a stated constant, not a measurement of any device. The
# tests pass their own budgets.
CPU_HBM_BYTES = 8 << 30


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Without one, raise rather than run quietly on
    the CPU; ``device="cpu"`` is the explicit opt-in the tests use."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def hbm_budget_bytes(device=None) -> int:
    """Device memory a forward starting now may allocate: on a CUDA device
    the card's own total (``total_memory``: about 79 GiB on an H100 80GB)
    less what the caching allocator already holds in live tensors (the
    parameters and inputs, which the AutoChunk model does not count); on
    the CPU (or ``None``) ``CPU_HBM_BYTES``."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if dev.type != "cuda":
        return CPU_HBM_BYTES
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return (torch.cuda.get_device_properties(idx).total_memory
            - torch.cuda.memory_allocated(idx))
