"""Training in the port: losses, step functions and the fault-tolerant
trainer (torch counterparts of ``repro.train``)."""
from repro_torch.train.losses import cross_entropy, total_loss
from repro_torch.train.steps import (make_decode_step, make_loss_fn,
                                     make_prefill_step, make_train_step)
from repro_torch.train.trainer import Trainer, TrainerReport

__all__ = ["cross_entropy", "total_loss", "make_train_step",
           "make_loss_fn", "make_prefill_step", "make_decode_step",
           "Trainer", "TrainerReport"]
