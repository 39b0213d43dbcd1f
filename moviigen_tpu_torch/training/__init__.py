from .train_step import TrainConfig, make_optimizer, make_train_step

__all__ = ["TrainConfig", "make_optimizer", "make_train_step"]
