"""
kraken_tpu_torch.train.optim
~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Optimizers and learning-rate schedules, the counterparts of the JAX
package's ``train/optim.py`` (reference: kraken/train/utils.py:246-313),
which builds them from optax. Each step here follows the optax
transformation step for step:

- the schedules are optax's formulas as plain functions of the optimizer's
  step count (``exponential_decay`` in staircase, ``cosine_decay_schedule``
  with ``alpha``, ``cosine_onecycle_schedule`` with pct 0.3, div 25 and
  final div 1e4, a linear warmup joined in front), set as each parameter
  group's lr before every step;
- ``clip_by_global_norm``: the gradients scaled by ``max_norm / ‖g‖`` when
  the global norm reaches ``max_norm`` (no epsilon), before the optimizer;
- ``Adam``, ``AdamW`` and ``SGD`` (with momentum) are ``torch.optim``'s,
  whose updates equal optax's (AdamW decays by ``lr·wd·p`` in both);
  ``RMSprop`` (decay 0.9, eps 1e-8 inside the square root, the momentum
  trace over the lr-scaled update) and ``Lamb`` (Adam with eps 1e-6, the
  decayed weights, the per-tensor trust ratio ``‖p‖ / ‖u‖``) are written
  here, as torch has no optax-equal counterpart;
- ``accumulate_grad_batches`` k > 1 is ``optax.MultiSteps``: the running
  mean of k mini-batch gradients, one optimizer step (and one schedule
  count) every k mini-batches, no update in between.

Reduce-on-plateau multiplies the update (``rop_scale``), as the JAX trainer
does, so the optimizer's moments carry over.

One difference, a fault of the reference that the port repairs: with
``1cycle`` and at most 3 optimizer steps in all, ``int(0.3·total)`` is 0,
and optax interpolates over that empty interval, so every rate of the JAX
package is NaN. :func:`_onecycle` skips the empty interval: for a total of
3 the rates are 1e-3, 7.5e-4, 2.5e-4, then 4e-9 at lr 1e-3
(``tests/test_torch_train_parity.py``, ROADMAP.md queue 3).
"""
import math
from typing import Callable, Optional, Sequence

import torch

__all__ = ['build_lr_schedule', 'Optimizer', 'OPTIMIZERS', 'SCHEDULES']

OPTIMIZERS = ('Adam', 'AdamW', 'SGD', 'RMSprop', 'Lamb')
SCHEDULES = ('constant', 'exponential', 'cosine', 'step', 'reduceonplateau', '1cycle')


def _exponential(init: float, transition_steps: int, rate: float) -> Callable[[int], float]:
    """optax.exponential_decay(init, transition_steps, rate, staircase=True)."""
    if transition_steps <= 0 or rate == 0:
        return lambda count: init
    return lambda count: init if count <= 0 else init * rate ** math.floor(count / transition_steps)


def _cosine(init: float, decay_steps: int, alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule(init, decay_steps, alpha)."""
    def schedule(count):
        count = min(count, decay_steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * count / decay_steps)) + alpha)
    return schedule


def _onecycle(total: int, peak: float, pct_start: float = 0.3, div: float = 25.0,
              final_div: float = 1e4) -> Callable[[int], float]:
    """optax.cosine_onecycle_schedule(total, peak): cosine interpolation
    from peak/div up to peak at ``int(pct_start·total)``, then down to
    peak/div/final_div at total, constant after."""
    bounds = (0, int(pct_start * total), int(total))
    values = (peak / div, peak, peak / div / final_div)

    def schedule(count):
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                return values[i + 1] + (values[i] - values[i + 1]) / 2.0 * (math.cos(math.pi * pct) + 1)
        return values[2] if count >= bounds[2] else 0.0
    return schedule


def build_lr_schedule(config, steps_per_epoch: int = 1) -> Callable[[int], float]:
    """
    The learning rate as a function of the optimizer's step count, as the
    JAX package's ``build_lr_schedule`` builds it from a TrainingConfig:
    a linear warmup over ``config.warmup`` steps, epoch-granular schedules
    scaled by `steps_per_epoch`; reduce-on-plateau is applied outside (it
    depends on validation), so its schedule is the base rate.
    """
    lr = config.lrate
    schedule = config.schedule
    if schedule == 'exponential':
        base = _exponential(lr, steps_per_epoch, config.gamma)
    elif schedule == 'cosine':
        base = _cosine(lr, max(1, config.cos_t_max * steps_per_epoch), config.cos_min_lr / lr)
    elif schedule == 'step':
        base = _exponential(lr, config.step_size * steps_per_epoch, config.gamma)
    elif schedule == '1cycle':
        base = _onecycle(max(1, (config.epochs if config.epochs > 0 else 10) * steps_per_epoch), lr)
    else:  # constant, reduceonplateau
        def base(count):
            return lr
    warmup = config.warmup
    if warmup > 0:
        return lambda count: lr * min(count, warmup) / warmup if count < warmup \
            else base(count - warmup)
    return base


class Optimizer:
    """
    The training optimizer of a list of parameters, built from a
    TrainingConfig: clipping, then the optimizer with its schedule, then
    (``accumulate_grad_batches`` > 1) gradient accumulation, as the JAX
    package's ``build_optimizer`` chains them.

    :meth:`step` reads the parameters' ``.grad`` (None counts as zeros) and
    updates the parameters in place; :meth:`state_tensors` and
    :meth:`load_state_tensors` give and take its whole state as named
    tensors (checkpoints).
    """

    def __init__(self, params: Sequence[torch.Tensor], config, steps_per_epoch: int = 1):
        self.params = list(params)
        self.name = config.optimizer
        if self.name not in OPTIMIZERS:
            raise ValueError(f'Unknown optimizer {self.name}')
        self.schedule = build_lr_schedule(config, steps_per_epoch)
        self.weight_decay = config.weight_decay
        self.momentum = config.momentum
        self.clip = config.gradient_clip_val
        self.accumulate = max(1, int(config.accumulate_grad_batches or 1))
        # optimizer steps taken (optax's inner count), mini-batches
        # accumulated towards the next one and their running mean
        self.count = 0
        self.mini_step = 0
        self.acc: Optional[list[torch.Tensor]] = None
        lr = self.schedule(0)
        if self.name == 'Adam':
            self.torch_opt = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        elif self.name == 'AdamW':
            self.torch_opt = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                               weight_decay=self.weight_decay)
        elif self.name == 'SGD':
            self.torch_opt = torch.optim.SGD(self.params, lr=lr, momentum=self.momentum)
        else:
            self.torch_opt = None
        # RMSprop: nu, trace; Lamb: mu, nu (by parameter index)
        self.state: dict[int, dict[str, torch.Tensor]] = {}

    def lr(self, rop_scale: float = 1.0) -> float:
        """The learning rate of the next optimizer step."""
        return self.schedule(self.count) * rop_scale

    def _grads(self) -> list[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, rop_scale: float = 1.0) -> bool:
        """One mini-batch's step from the parameters' gradients; returns
        whether the parameters moved (False while gradients accumulate)."""
        grads = self._grads()
        if self.accumulate > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            k = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (k + 1))
            self.mini_step += 1
            if self.mini_step < self.accumulate:
                return False
            grads, self.acc, self.mini_step = self.acc, None, 0
        if self.clip:
            norm = torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in grads))
            scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
            grads = [g * scale.to(g.dtype) for g in grads]
        if self.torch_opt is not None:
            for p, g in zip(self.params, grads):
                p.grad = g
            for group in self.torch_opt.param_groups:
                group['lr'] = self.lr(rop_scale)
            self.torch_opt.step()
        elif self.name == 'RMSprop':
            self._rmsprop(grads, self.lr(), rop_scale)
        else:
            self._lamb(grads, self.lr(), rop_scale)
        self.count += 1
        return True

    def _rmsprop(self, grads, lr: float, rop_scale: float) -> None:
        """optax.rmsprop(lr, momentum): nu = 0.9·nu + 0.1·g², u = -lr·g /
        sqrt(nu + 1e-8), trace = u + momentum·trace, p += rop·trace."""
        for i, (p, g) in enumerate(zip(self.params, grads)):
            st = self.state.setdefault(i, {'nu': torch.zeros_like(p), 'trace': torch.zeros_like(p)})
            st['nu'].mul_(0.9).add_(0.1 * g * g)
            u = -lr * g * torch.rsqrt(st['nu'] + 1e-8)
            st['trace'].mul_(self.momentum).add_(u)
            p.add_(rop_scale * st['trace'])

    def _lamb(self, grads, lr: float, rop_scale: float) -> None:
        """optax.lamb(lr, weight_decay): Adam (b1 0.9, b2 0.999, eps 1e-6,
        bias-corrected), plus wd·p, times the trust ratio ‖p‖/‖u‖ (1 where
        either is 0), times -lr."""
        t = self.count + 1
        for i, (p, g) in enumerate(zip(self.params, grads)):
            st = self.state.setdefault(i, {'mu': torch.zeros_like(p), 'nu': torch.zeros_like(p)})
            st['mu'].mul_(0.9).add_(0.1 * g)
            st['nu'].mul_(0.999).add_(0.001 * g * g)
            mu_hat = st['mu'] / (1 - 0.9 ** t)
            nu_hat = st['nu'] / (1 - 0.999 ** t)
            u = mu_hat / (torch.sqrt(nu_hat) + 1e-6) + self.weight_decay * p
            p_norm, u_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
            ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                                p_norm / u_norm)
            p.add_(-lr * rop_scale * ratio * u)

    # ------------------------------------------------------------- state
    def state_tensors(self) -> dict[str, torch.Tensor]:
        """The whole state as named tensors (counts included)."""
        out = {'count': torch.tensor(self.count), 'mini_step': torch.tensor(self.mini_step)}
        state = self.torch_opt.state_dict()['state'] if self.torch_opt is not None else self.state
        for i, st in state.items():
            for k, v in st.items():
                out[f'state.{i}.{k}'] = torch.as_tensor(v)
        for i, a in enumerate(self.acc or []):
            out[f'acc.{i}'] = a
        return out

    def load_state_tensors(self, tensors: dict[str, torch.Tensor]) -> None:
        """Restores :meth:`state_tensors`' output."""
        self.count = int(tensors['count'])
        self.mini_step = int(tensors['mini_step'])
        state: dict[int, dict[str, torch.Tensor]] = {}
        acc = {}
        for key, v in tensors.items():
            parts = key.split('.')
            if parts[0] == 'state':
                p = self.params[int(parts[1])]
                state.setdefault(int(parts[1]), {})[parts[2]] = \
                    v.to(p.device) if parts[2] != 'step' else v
            elif parts[0] == 'acc':
                acc[int(parts[1])] = v.to(self.params[int(parts[1])].device)
        self.acc = [acc[i] for i in range(len(acc))] if acc else None
        if self.torch_opt is not None:
            sd = self.torch_opt.state_dict()
            sd['state'] = state
            self.torch_opt.load_state_dict(sd)
        else:
            self.state = state
