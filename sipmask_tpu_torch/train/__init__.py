"""Training of the port: optimizer and schedule, train state, train step."""

from .optim import lr_schedule, make_optimizer
from .state import TrainState, create_train_state
from .step import make_train_step
