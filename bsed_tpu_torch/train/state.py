"""Train state and optimizer. Port of ``bsed_tpu/train/state.py`` and of
``_base_optimizer`` (``bsed_tpu/train/steps.py:75-89``): what the JAX
package keeps as one immutable pytree is here the student and teacher
modules and the optimizer, which the step updates in place, plus the step
count; in the adaptation stage also the discriminator, its optimizer and
the encoder's aux optimizer."""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module                # student: encoder + predictor
    ema_model: Optional[torch.nn.Module]  # mean teacher (no gradients)
    optimizer: torch.optim.Optimizer      # over the student's parameters
    # adversarial adaptation (None outside the adaptation stage)
    discriminator: Optional[torch.nn.Module] = None
    disc_optimizer: Optional[torch.optim.Optimizer] = None
    enc_optimizer: Optional[torch.optim.Optimizer] = None  # encoder only


def make_optimizer(cfg, params: Iterable[torch.nn.Parameter],
                   family: Optional[str] = None,
                   lr: Optional[float] = None) -> torch.optim.Optimizer:
    """The optimizer of ``family`` (default ``cfg.train.optimizer``; the
    aux optimizers pass ``cfg.da.aux_optimizer``, since two scripts mix
    families), at ``lr`` (default the constant max_learning_rate: the
    train step sets each step's lr on its param groups; the tagger keeps
    its own constant rate):

      * "adam": Adam(β 0.9, 0.999, ε 1e-8), optax.adam's;
      * "sgd": SGD with Nesterov momentum 0.9 and weight decay 1e-4
        (main_scmt_ada_weak.py:854-862). torch adds the decay to the
        gradient before the momentum trace, as optax's
        ``chain(add_decayed_weights, sgd(nesterov=True))`` does, and its
        ``momentum_buffer`` is optax's trace."""
    t = cfg.train
    family = family or t.optimizer
    lr = t.max_learning_rate if lr is None else lr
    if family == "adam":
        return torch.optim.Adam(params, lr=lr,
                                betas=(0.9, 0.999), eps=1e-8)
    if family == "sgd":
        return torch.optim.SGD(params, lr=lr,
                               momentum=t.sgd_momentum, nesterov=True,
                               weight_decay=t.sgd_weight_decay)
    raise ValueError(f"unknown optimizer {family!r}")
