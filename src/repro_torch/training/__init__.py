from .trainer import TrainConfig, TrainResult, make_train_step, train
