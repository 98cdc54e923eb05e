from repro_torch.train.step import (TrainState, init_train_state,  # noqa: F401
                                    make_train_step, train_state_pspecs)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
