"""
kraken_tpu_torch.train.losses
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Training losses, the counterparts of the JAX package's ``train/losses.py``:
the recognition loss is CTC, the segmentation loss BCE-with-logits plus a
weighted soft Dice term (reference: kraken/train/losses.py +
train/blla.py:277-294). All of them are torch ops.

CTC is ``F.ctc_loss(reduction='sum', zero_infinity=True)`` on the log
softmax, the reference's ``torch.nn.CTCLoss``. On lines whose labels fit
their frames it equals the JAX package's ``optax.ctc_loss`` sum (its loss
and gradients, ``tests/test_torch_train_parity.py``). On a line whose labels
cannot fit (more frames needed than it has, repeats counting a blank
between) torch's loss is infinite and zeroed, as the documented
zero_infinity semantics ask; optax returns about 1e5 there (its
``log_epsilon``), which the JAX ``isfinite`` filter does not catch, so the
JAX loss counts such a line and the port drops it (ROADMAP.md queue 3).

In data-parallel training each rank's loss is its shard's, and the trainer
averages the ranks' gradients: that is the global loss's gradient for the
means (BCE over equal shards, CTC's sum over the global batch size). The
Dice term sums over the batch axis and adds ``smooth`` to a ratio of sums,
so its sums are summed over the ranks first (:func:`dice_loss` with a
``world``).
"""
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ['ctc_loss', 'bce_logits_loss', 'dice_loss', 'segmentation_loss']


def ctc_loss(logits: torch.Tensor, olens: torch.Tensor, labels: torch.Tensor,
             label_lens: torch.Tensor) -> torch.Tensor:
    """
    Summed CTC loss over a batch (blank = class 0), non-finite lines zeroed.

    Args:
        logits: (N, C, 1, W) network output (before the softmax).
        olens: (N,) valid output widths.
        labels: (N, L) padded 1-indexed label sequences.
        label_lens: (N,) label sequence lengths.
    """
    log_probs = torch.log_softmax(logits.squeeze(2).to(torch.float32), dim=1)
    log_probs = log_probs.permute(2, 0, 1)  # (W, N, C)
    return F.ctc_loss(log_probs, labels.to(torch.long), olens.to(torch.long),
                      label_lens.to(torch.long), blank=0, reduction='sum', zero_infinity=True)


def bce_logits_loss(logits: torch.Tensor, targets: torch.Tensor,
                    mean: bool = True) -> torch.Tensor:
    """Numerically stable binary cross entropy on logits (the JAX form)."""
    loss = torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return loss.mean() if mean else loss


class _SumOverRanks(torch.autograd.Function):
    """The sum of a tensor over the ranks of a world. The sum, and so
    whatever follows from it, is the same on every rank; each rank passes
    the gradient on to its own share times the world size, so that the
    ranks' averaged gradient is the gradient of the function of the
    global sum."""

    @staticmethod
    def forward(ctx, x, world):
        ctx.size = world.size
        return world.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.size, None


def dice_loss(logits: torch.Tensor, targets: torch.Tensor, smooth: float = 1.0,
              world=None) -> torch.Tensor:
    """Soft Dice loss over sigmoid probabilities, one term a class averaged
    over the classes; with a ``parallel.World``, over the global batch of
    its ranks' shards."""
    probs = torch.sigmoid(logits.to(torch.float32))
    dims = (0, 2, 3)
    intersection = (probs * targets).sum(dims)
    cardinality = probs.sum(dims) + targets.sum(dims)
    if world is not None:
        intersection, cardinality = _SumOverRanks.apply(
            torch.stack([intersection, cardinality]), world)
    dice = (2 * intersection + smooth) / (cardinality + smooth)
    return (1 - dice).mean()


def segmentation_loss(logits: torch.Tensor, targets: torch.Tensor,
                      dice_weight: Optional[float] = 0.5, world=None) -> torch.Tensor:
    """BCE + weighted soft Dice, the baseline segmentation training
    criterion (reference: train/blla.py:277-294); dice_weight 0 drops the
    Dice term. With a ``world`` the Dice term is the global batch's."""
    loss = bce_logits_loss(logits, targets)
    if dice_weight and dice_weight > 0:
        loss = loss + dice_weight * dice_loss(logits, targets, world=world)
    return loss
