"""Training: the train state and the step factory."""
from repro_torch.train.loop import (  # noqa: F401
    instrument_train_step, make_train_step)
from repro_torch.train.state import TrainState, make_train_state  # noqa: F401
