from .train import TrainState, init_train_state, make_train_step  # noqa: F401
