"""
kraken_tpu_torch.ops.ctc
~~~~~~~~~~~~~~~~~~~~~~~~

CTC decoders for softmax outputs of recognition networks.

The contract matches the reference decoder (kraken/lib/ctc_decoder.py):
input is a (C, W) or (N, C, W) softmax tensor, output one list per batch row
of (label, start, end, max_prob) runs with blanks (label 0) removed.

Device/host split: the per-frame argmax/max reductions of the greedy path
run on the device inside the recognition forward; run-length grouping of
the tiny (W,) label vector is vectorized numpy on the host. A beam-search
decoder over the top-k label posteriors is also provided.
"""
from typing import Optional, Union

import numpy as np

__all__ = ['greedy_decoder', 'beam_decoder', 'blank_threshold_decoder']


def _group_runs(labels: np.ndarray, confs: np.ndarray) -> list[tuple[int, int, int, float]]:
    """Vectorized run-length grouping of one label sequence."""
    w = len(labels)
    if w == 0:
        return []
    change = np.flatnonzero(np.diff(labels)) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change - 1, [w - 1]))
    run_labels = labels[starts]
    run_confs = np.maximum.reduceat(confs, starts)
    keep = run_labels != 0
    return [(int(lb), int(s), int(e), float(c))
            for lb, s, e, c in zip(run_labels[keep], starts[keep], ends[keep], run_confs[keep])]


def greedy_decoder(outputs, seq_lens=None) -> list[list[tuple[int, int, int, float]]]:
    """
    Best-path (greedy) CTC decoding.

    Args:
        outputs: (C, W) or (N, C, W) softmax output array.
        seq_lens: per-row valid widths; may be omitted for batch size 1.

    Returns:
        One list per row of (label, start, end, max_prob) tuples for the
        collapsed non-blank runs.
    """
    arr = np.asarray(outputs)
    if arr.ndim == 2:
        arr = arr[None]
    if seq_lens is None:
        if arr.shape[0] != 1:
            raise ValueError('Batch decoding requires seq_lens.')
        seq_lens = [arr.shape[-1]]
    labels = arr.argmax(axis=1)
    confs = arr.max(axis=1)
    return [_group_runs(labels[i, :int(l)], confs[i, :int(l)])
            for i, l in enumerate(np.asarray(seq_lens))]


def blank_threshold_decoder(outputs, threshold: float = 0.5,
                            seq_lens=None) -> list[list[tuple[int, int, int, float]]]:
    """
    Legacy ocropy-style thresholding decoder: regions where the non-blank
    probability mass exceeds `threshold` are collapsed to the single best
    label inside each region.
    """
    arr = np.asarray(outputs)
    if arr.ndim == 2:
        arr = arr[None]
    if seq_lens is None:
        seq_lens = [arr.shape[-1]] * arr.shape[0]
    results = []
    for row, sl in zip(arr, np.asarray(seq_lens)):
        row = row[:, :int(sl)]
        active = (1 - row[0]) > threshold
        if not active.any():
            results.append([])
            continue
        change = np.flatnonzero(np.diff(active.astype(np.int8)))
        bounds = np.concatenate(([0], change + 1, [row.shape[1]]))
        out = []
        for s, e in zip(bounds[:-1], bounds[1:]):
            if not active[s]:
                continue
            seg = row[1:, s:e]
            label = int(seg.max(axis=1).argmax()) + 1
            conf = float(seg.max())
            out.append((label, int(s), int(e - 1), conf))
        results.append(out)
    return results


def beam_decoder(outputs, beam_size: int = 3, seq_lens=None,
                 topk: int = 8) -> list[list[tuple[int, int, int, float]]]:
    """
    Prefix beam-search CTC decoding over the top-k per-frame labels.

    Standard CTC prefix beam search (Graves 2006/Hannun 2014) tracking blank
    and non-blank path probabilities per prefix. Restricting transitions to
    the per-frame top-k labels keeps host cost linear in width while being
    numerically equivalent for peaked OCR posteriors.

    Returns the same (label, start, end, prob) run format as
    :func:`greedy_decoder`, with prob the per-label posterior mass of the
    winning beam.
    """
    arr = np.asarray(outputs)
    if arr.ndim == 2:
        arr = arr[None]
    if seq_lens is None:
        seq_lens = [arr.shape[-1]] * arr.shape[0]
    results = []
    for row, sl in zip(arr, np.asarray(seq_lens)):
        row = row[:, :int(sl)]  # (C, W)
        C, W = row.shape
        k = min(topk, C)
        frame_topk = np.argpartition(-row, k - 1, axis=0)[:k]  # (k, W)
        # beams: prefix tuple -> (p_blank, p_nonblank, positions)
        beams = {(): (1.0, 0.0, ())}
        for t in range(W):
            probs = row[:, t]
            cands = frame_topk[:, t]
            new_beams: dict = {}

            def _acc(prefix, pb, pnb, pos):
                opb, opnb, opos = new_beams.get(prefix, (0.0, 0.0, pos))
                npb, npnb = opb + pb, opnb + pnb
                # keep positions of the higher-probability path
                npos = pos if (pb + pnb) > (opb + opnb) else opos
                new_beams[prefix] = (npb, npnb, npos)

            for prefix, (p_b, p_nb, pos) in beams.items():
                total = p_b + p_nb
                for c in cands:
                    p = probs[c]
                    if c == 0:
                        _acc(prefix, total * p, 0.0, pos)
                    elif prefix and prefix[-1] == c:
                        # repeat: extends the non-blank path of the same
                        # prefix, or starts a new symbol after a blank
                        _acc(prefix, 0.0, p_nb * p, pos)
                        _acc(prefix + (int(c),), 0.0, p_b * p, pos + ((t, t),))
                    else:
                        _acc(prefix + (int(c),), 0.0, total * p, pos + ((t, t),))
                # extend end frame of last symbol for repeats
            beams = dict(sorted(new_beams.items(),
                                key=lambda kv: kv[1][0] + kv[1][1],
                                reverse=True)[:beam_size])
        best_prefix, (p_b, p_nb, pos) = max(beams.items(), key=lambda kv: kv[1][0] + kv[1][1])
        out = []
        for label, (s, e) in zip(best_prefix, pos):
            out.append((int(label), int(s), int(e), float(row[label, s:e + 1].max())))
        results.append(out)
    return results
