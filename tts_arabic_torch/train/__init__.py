"""FastPitch training, MSE recipe: losses, the train and eval steps, and the
training loop."""
from .losses import (attention_binarization_loss, attention_ctc_loss,
                     fastpitch_loss)
from .steps import (TrainState, make_fastpitch_eval_step,
                    make_fastpitch_train_step, make_optimizer)
from .trainer import Trainer

__all__ = ["TrainState", "Trainer", "attention_binarization_loss",
           "attention_ctc_loss", "fastpitch_loss", "make_fastpitch_eval_step",
           "make_fastpitch_train_step", "make_optimizer"]
