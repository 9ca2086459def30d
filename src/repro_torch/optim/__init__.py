"""Optimizers of the port: AdamW (bf16-moment option) and Adafactor
(factored second moments), with the reference's warmup + cosine schedule.
Torch counterparts of ``repro.optim``: functional updates on the port's
parameter trees, float32 math."""
from repro_torch.config import TrainConfig
from repro_torch.optim import adafactor, adamw
from repro_torch.optim.schedule import learning_rate

__all__ = ["TrainConfig", "adafactor", "adamw", "learning_rate",
           "init_state", "apply_updates"]


def init_state(params, tc: TrainConfig, layout=None):
    """The optimizer state ``tc.optimizer`` names, for ``params``;
    Adafactor's stacked statistics follow ``layout``, the model's
    ``(prefix, steps)`` (``models.blocks.step_layout``)."""
    if tc.optimizer == "adafactor":
        return adafactor.init_state(params, tc, layout)
    return adamw.init_state(params, tc)


def apply_updates(params, grads, state, tc: TrainConfig, lr, layout=None):
    """One update: ``(new_params, new_state, metrics)``."""
    if tc.optimizer == "adafactor":
        return adafactor.apply_updates(params, grads, state, tc, lr, layout)
    return adamw.apply_updates(params, grads, state, tc, lr)
