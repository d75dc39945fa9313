"""TrainState: fp32 master parameters, optimizer state and a step counter."""
from __future__ import annotations

from typing import NamedTuple

import torch


class TrainState(NamedTuple):
    step: torch.Tensor      # 0-d int32, on the CPU
    params: dict
    opt_state: object


def make_train_state(params, opt_init) -> TrainState:
    return TrainState(torch.zeros((), dtype=torch.int32), params,
                      opt_init(params))
