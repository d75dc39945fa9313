"""Training: the train state and the step factory."""
from repro_torch.train.loop import make_train_step  # noqa: F401
from repro_torch.train.state import TrainState, make_train_state  # noqa: F401
