from repro_torch.train.trainer import (TrainConfig, Trainer,  # noqa: F401
                                       make_train_step)
