"""
kraken_tpu_torch.lib.segmentation_metrics
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

A copy of the JAX package's ``lib/segmentation_metrics.py``.

Baseline detection evaluation (Transkribus-style scheme with optimal
matching; reference: kraken/lib/segmentation_metrics.py): polylines are
resampled to uniform spacing, scored symmetrically with a tolerance
falloff, and matched with the Hungarian algorithm to produce P/R/F1.

Implemented on numpy; the all-pairs distance computation is fully
vectorized.
"""
import logging

import numpy as np
from scipy.optimize import linear_sum_assignment

logger = logging.getLogger(__name__)

__all__ = ['interpolate_polyline', 'baseline_score', 'match_baselines',
           'compute_detection_metrics', 'aggregate_detection_metrics']


def interpolate_polyline(points: np.ndarray, spacing: float = 5.0) -> np.ndarray:
    """
    Resamples a polyline to approximately uniform point spacing.

    Args:
        points: (N, 2) polyline vertices.
        spacing: target point distance in pixels.
    """
    points = np.asarray(points, np.float64)
    if points.shape[0] < 2:
        return points
    seg_lengths = np.linalg.norm(np.diff(points, axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg_lengths)])
    total = cum[-1]
    if total < 1e-6:
        return points[:1]
    num = max(2, int(round(total / spacing)))
    targets = np.linspace(0, total, num)
    idx = np.clip(np.searchsorted(cum, targets), 1, len(cum) - 1)
    seg_start = cum[idx - 1]
    seg_len = cum[idx] - seg_start
    t = np.where(seg_len > 1e-8, (targets - seg_start) / np.where(seg_len > 0, seg_len, 1), 0.0)
    return points[idx - 1] + t[:, None] * (points[idx] - points[idx - 1])


def _point_scores(min_dists: np.ndarray, tol: float) -> np.ndarray:
    """Tolerance-falloff point scores: 1 within tol, linear to 0 at 3·tol."""
    return np.where(min_dists <= tol, 1.0,
                    np.where(min_dists < 3 * tol,
                             (3 * tol - min_dists) / (2 * tol), 0.0))


def baseline_score(pred_points: np.ndarray, gt_points: np.ndarray, tol: float) -> float:
    """Directed mean point score from pred to gt."""
    d = np.linalg.norm(pred_points[:, None, :] - gt_points[None, :, :], axis=-1)
    return float(_point_scores(d.min(axis=1), tol).mean())


def match_baselines(pred_polylines: list, gt_polylines: list, tol: float):
    """
    Symmetric score matrix + Hungarian assignment over baseline pairs.

    Returns:
        (score_matrix (P, G), matches [(pred, gt)], match_scores).
    """
    n_pred = len(pred_polylines)
    n_gt = len(gt_polylines)
    scores = np.zeros((n_pred, n_gt))
    for i, pred in enumerate(pred_polylines):
        for j, gt in enumerate(gt_polylines):
            scores[i, j] = (baseline_score(pred, gt, tol) +
                            baseline_score(gt, pred, tol)) / 2.0
    row, col = linear_sum_assignment(1.0 - scores)
    matches = list(zip(row.tolist(), col.tolist()))
    return scores, matches, scores[row, col]


def compute_detection_metrics(pred_polylines: list, gt_polylines: list,
                              tol: float) -> dict[str, float]:
    """Per-page precision/recall/F1 of baseline detection."""
    n_pred = len(pred_polylines)
    n_gt = len(gt_polylines)
    if n_pred == 0 and n_gt == 0:
        return {'precision': 1.0, 'recall': 1.0, 'f1': 1.0, 'num_pred': 0, 'num_gt': 0}
    if n_pred == 0 or n_gt == 0:
        return {'precision': 0.0, 'recall': 0.0, 'f1': 0.0,
                'num_pred': n_pred, 'num_gt': n_gt}
    _, _, match_scores = match_baselines(pred_polylines, gt_polylines, tol)
    precision = float(match_scores.sum()) / n_pred
    recall = float(match_scores.sum()) / n_gt
    f1 = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
    return {'precision': precision, 'recall': recall, 'f1': f1,
            'num_pred': n_pred, 'num_gt': n_gt}


def aggregate_detection_metrics(page_metrics: list[dict]) -> dict[str, float]:
    """Macro-average of per-page detection metrics."""
    if not page_metrics:
        return {'precision': 0.0, 'recall': 0.0, 'f1': 0.0}
    n = len(page_metrics)
    return {'precision': sum(m['precision'] for m in page_metrics) / n,
            'recall': sum(m['recall'] for m in page_metrics) / n,
            'f1': sum(m['f1'] for m in page_metrics) / n}
