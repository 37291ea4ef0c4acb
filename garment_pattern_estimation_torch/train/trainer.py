"""The training step of the port: optimizer, one-cycle schedule, loss-phase
bookkeeping, and one train or eval step on a batch.

Counterpart of garment_pattern_estimation_tpu/train/trainer.py:123-266.
`Trainer.fit` over a dataset waits for the port's own copies of the data
pipeline (ROADMAP queue A6); a caller drives the steps itself:

    trainer = Trainer(config['trainer'])                  # on CUDA
    trainer.make_optimizer(model, steps_per_epoch)
    loss, terms = trainer.train_step(model, batch, epoch, generator)

A batch is {'features': (B, N, 3) standardized points, 'ground_truth':
{name: tensor}} as the dataset yields it.
"""
from __future__ import annotations

import math

import torch

from ..device import resolve_device


def cosine_onecycle_schedule(transition_steps, peak_value, pct_start=0.3,
                             div_factor=25.0, final_div_factor=1e4):
    """optax.cosine_onecycle_schedule: from peak / div_factor up to the peak
    over int(pct_start * transition_steps) steps, then down to
    peak / (div_factor * final_div_factor) at `transition_steps`, both
    halves cosine; held there after. Like optax, the cosine and the blend
    are taken in float32 (the half range in float64 first). Returns
    step -> lr (float)."""
    if transition_steps <= 0:
        raise ValueError('cosine_onecycle_schedule: transition_steps must be positive')
    bounds = [0, int(pct_start * transition_steps), int(transition_steps)]
    values = [peak_value / div_factor]              # optax's cumulative product
    values += [values[0] * div_factor, values[0] * div_factor / (div_factor * final_div_factor)]

    def schedule(step):
        for i in range(2):
            if bounds[i] <= step < bounds[i + 1]:
                pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
                cos = torch.cos(torch.tensor(math.pi * pct, dtype=torch.float32))
                end = torch.tensor(values[i + 1], dtype=torch.float32)
                half = torch.tensor((values[i] - values[i + 1]) / 2.0, dtype=torch.float32)
                return float(end + half * (cos + 1))
        return values[2]

    return schedule


def phase_of(loss_config, epoch):
    """(stitch phase, random-order phase) of `epoch`."""
    ews = loss_config.get('epoch_with_stitches', 40)
    ewo = loss_config.get('epoch_with_order_matching', 0)
    return epoch >= ews, epoch < ewo and loss_config.get('panel_order_inariant_loss', False)


def canonical_epoch(loss_config, stitch_phase, order_random):
    """A representative epoch with the phase's decisions: the loss sees it
    in place of the raw epoch, as the JAX trainer's cached steps do."""
    ews = loss_config.get('epoch_with_stitches', 40)
    ewo = loss_config.get('epoch_with_order_matching', 0)
    for epoch in range(0, max(ews, ewo) + 2):
        if (epoch >= ews) == stitch_phase and (epoch < ewo) == order_random:
            return epoch
    raise ValueError(f'Trainer: unsatisfiable loss phase: stitch={stitch_phase} '
                     f'order_random={order_random} (ews={ews}, ewo={ewo})')


class Trainer:
    """`setup` is the config's `trainer:` section (learning_rate, optimizer,
    weight_decay, lr_scheduling, epochs, ...)."""

    def __init__(self, setup, device=None):
        self.setup = dict(setup)
        self.device = resolve_device(device)
        self.optimizer = None
        self.schedule = None
        self.step_count = 0

    def make_optimizer(self, model, steps_per_epoch):
        """Adam or SGD over the model's parameters with the one-cycle (or a
        constant) schedule over epochs x steps_per_epoch steps; weight decay
        is added to the gradient, as torch's optimizers and the JAX
        package's optax chain both do."""
        lr = float(self.setup['learning_rate'])
        if self.setup.get('lr_scheduling') is not None:
            # optax's schedule is NaN when a phase rounds to zero length
            total_steps = self.setup['epochs'] * max(steps_per_epoch, 1)
            self.schedule = cosine_onecycle_schedule(max(total_steps, 4), lr)
        else:
            self.schedule = lambda step: lr
        weight_decay = float(self.setup.get('weight_decay', 0) or 0)
        params = model.module.parameters()
        if self.setup.get('optimizer', 'SGD') == 'Adam':
            self.optimizer = torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)
        else:
            self.optimizer = torch.optim.SGD(params, lr=lr, weight_decay=weight_decay)
        self.step_count = 0
        return self.optimizer

    def _place(self, batch):
        gt = {k: v.to(self.device, non_blocking=True)
              for k, v in batch['ground_truth'].items()}
        return batch['features'].to(self.device, non_blocking=True).float(), gt

    def train_step(self, model, batch, epoch, generator=None):
        """One optimizer step on `batch`: train-mode forward (batch
        statistics, BN running averages updated), the composed loss at the
        epoch's phase, backward, update. The lr is the schedule at the
        number of steps taken before this one. `generator` draws the LSTM
        decoder's random initial states. Returns (loss, dict of the loss
        terms and quality metrics), detached, on the device."""
        if self.optimizer is None:
            raise RuntimeError('Trainer: call make_optimizer before train_step')
        features, gt = self._place(batch)
        epoch_c = canonical_epoch(model.loss.config, *phase_of(model.loss.config, epoch))
        for group in self.optimizer.param_groups:
            group['lr'] = self.schedule(self.step_count)
        model.module.train()
        self.optimizer.zero_grad(set_to_none=True)
        preds = model.module(features, generator=generator)
        loss, loss_dict, _ = model.loss(preds, gt, epoch=epoch_c)
        loss.backward()
        self.optimizer.step()
        self.step_count += 1
        return loss.detach(), {k: v.detach() for k, v in loss_dict.items()}

    @torch.no_grad()
    def eval_step(self, model, batch, epoch, generator=None):
        """Eval-mode forward (running statistics, the fused EdgeConv kernel
        on the card) and the composed loss with its quality metrics.
        `generator` draws the LSTM decoder's random initial states, as the
        JAX trainer's eval step draws them from its 'recurrent_init' rng;
        without one they are zeros. Returns (loss, dict)."""
        features, gt = self._place(batch)
        epoch_c = canonical_epoch(model.loss.config, *phase_of(model.loss.config, epoch))
        model.module.eval()
        preds = model.module(features, generator=generator)
        loss, loss_dict, _ = model.loss(preds, gt, epoch=epoch_c)
        return loss, loss_dict
