"""
kraken_tpu_torch.train.metrics
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Validation/test metrics, a copy of the JAX package's ``train/metrics.py``
(plain Python and numpy): character/word error rates (Levenshtein), and
multilabel pixel metrics for segmentation (replacing the reference's
torchmetrics use).
"""
import numpy as np

__all__ = ['levenshtein', 'CharErrorRate', 'WordErrorRate',
           'MultilabelAccuracy', 'MultilabelJaccard']


def levenshtein(a, b) -> int:
    """Edit distance between two sequences (vectorized row DP)."""
    if len(a) < len(b):
        a, b = b, a
    if not len(b):
        return len(a)
    b_arr = np.array(list(b))
    prev = np.arange(len(b) + 1)
    for i, ca in enumerate(a, start=1):
        cur = np.empty(len(b) + 1, dtype=np.int64)
        cur[0] = i
        # substitution and deletion are elementwise; insertion is sequential
        np.minimum(prev[:-1] + (b_arr != ca), prev[1:] + 1, out=cur[1:])
        for j in range(1, len(b) + 1):
            if cur[j] > cur[j - 1] + 1:
                cur[j] = cur[j - 1] + 1
        prev = cur
    return int(prev[-1])


class _ErrorRate:
    def __init__(self):
        self.errors = 0
        self.total = 0

    def reset(self):
        self.errors = 0
        self.total = 0

    def compute(self) -> float:
        return self.errors / self.total if self.total else 0.0


class CharErrorRate(_ErrorRate):
    """Accumulated character error rate over (prediction, target) pairs."""

    def update(self, pred: str, target: str) -> None:
        self.errors += levenshtein(pred, target)
        self.total += len(target)


class WordErrorRate(_ErrorRate):
    """Accumulated word error rate over (prediction, target) pairs."""

    def update(self, pred: str, target: str) -> None:
        pred_words = pred.split()
        target_words = target.split()
        self.errors += levenshtein(pred_words, target_words)
        self.total += len(target_words)


class MultilabelAccuracy:
    """Mean per-pixel accuracy of thresholded sigmoid heatmaps."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.correct = 0
        self.total = 0

    def reset(self):
        self.correct = 0
        self.total = 0

    def update(self, probs: np.ndarray, target: np.ndarray) -> None:
        pred = probs >= self.threshold
        self.correct += int((pred == (target >= 0.5)).sum())
        self.total += int(np.prod(target.shape))

    def compute(self) -> float:
        return self.correct / self.total if self.total else 0.0


class MultilabelJaccard:
    """Mean per-class IoU of thresholded sigmoid heatmaps."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.intersection = None
        self.union = None

    def reset(self):
        self.intersection = None
        self.union = None

    def update(self, probs: np.ndarray, target: np.ndarray) -> None:
        pred = probs >= self.threshold
        tgt = target >= 0.5
        axes = tuple(i for i in range(pred.ndim) if i != pred.ndim - 3)
        inter = np.logical_and(pred, tgt).sum(axis=axes).astype(np.int64)
        union = np.logical_or(pred, tgt).sum(axis=axes).astype(np.int64)
        if self.intersection is None:
            self.intersection = inter
            self.union = union
        else:
            self.intersection += inter
            self.union += union

    def compute(self) -> float:
        if self.union is None:
            return 0.0
        valid = self.union > 0
        if not valid.any():
            return 0.0
        return float((self.intersection[valid] / self.union[valid]).mean())
