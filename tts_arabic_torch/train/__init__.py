"""Training: FastPitch and Tacotron2 losses, the train and eval steps (MSE
and adversarial), the critic, and the training loop."""
from .gan import PatchDiscriminator, init_critic
from .losses import (attention_binarization_loss, attention_ctc_loss,
                     fastpitch_loss, tacotron2_loss)
from .steps import (TrainState, make_fastpitch_eval_step,
                    make_fastpitch_train_step, make_optimizer,
                    make_tacotron_eval_step, make_tacotron_train_step)
from .trainer import Trainer

__all__ = ["PatchDiscriminator", "TrainState", "Trainer",
           "attention_binarization_loss", "attention_ctc_loss",
           "fastpitch_loss", "init_critic", "make_fastpitch_eval_step",
           "make_fastpitch_train_step", "make_optimizer",
           "make_tacotron_eval_step", "make_tacotron_train_step",
           "tacotron2_loss"]
