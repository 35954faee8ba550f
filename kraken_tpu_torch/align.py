"""
kraken_tpu_torch.align
~~~~~~~~~~~~~~~~~~~~~~

Forced alignment of existing transcriptions against CTC network output
(reference: kraken/align.py, itself adapted from the torchaudio forced
alignment tutorial), a copy of the JAX package's ``align.py``: a
log-domain trellis over (frames × tokens), greedy backtrack, and repeat
merging.

The trellis is built with the numpy recurrence (:func:`get_trellis`) for
one line, or on the card for a batch of lines in one launch of the
hand-written kernel of ``csrc/trellis.cu`` (:func:`get_trellis_batch`,
:func:`get_trellis_device`), which gives numpy's trellis bit for bit.
"""
import logging
import warnings
from dataclasses import dataclass, replace
from typing import TYPE_CHECKING, Literal, Optional, Sequence

import numpy as np
import torch

from kraken_tpu_torch.containers import BaselineOCRRecord
from kraken_tpu_torch.lib.bidi import get_display
from kraken_tpu_torch.lib.util import open_image

if TYPE_CHECKING:
    from kraken_tpu_torch.containers import Segmentation
    from kraken_tpu_torch.lib.models import SeqRecognizer

logger = logging.getLogger(__name__)

__all__ = ['forced_align', 'get_trellis', 'get_trellis_device', 'get_trellis_batch',
           'backtrack', 'merge_repeats', 'align_line', 'prepare_line']


@dataclass
class Point:
    token_index: int
    time_index: int
    score: float


@dataclass
class Segment:
    label: str
    start: int
    end: int
    score: float

    @property
    def length(self):
        return self.end - self.start


def get_trellis(emission: np.ndarray, tokens: np.ndarray) -> np.ndarray:
    """
    Builds the alignment trellis.

    Args:
        emission: (frames, classes) log-probabilities.
        tokens: token label sequence (1-indexed, 0 = blank).

    Returns:
        (frames+1, tokens+1) trellis of cumulative log-probabilities.
    """
    num_frames = emission.shape[0]
    num_tokens = len(tokens)
    trellis = np.empty((num_frames + 1, num_tokens + 1), np.float32)
    trellis[0, 0] = 0
    trellis[1:, 0] = np.cumsum(emission[:, 0])
    trellis[0, 1:] = -np.inf
    trellis[-num_tokens:, 0] = np.inf
    token_emissions = emission[:, tokens]  # (frames, tokens)
    for t in range(num_frames):
        trellis[t + 1, 1:] = np.maximum(trellis[t, 1:] + emission[t, 0],
                                        trellis[t, :-1] + token_emissions[t])
    return trellis


def get_trellis_batch(emissions: Sequence[np.ndarray], tokens: Sequence[np.ndarray],
                      device='cuda') -> list[np.ndarray]:
    """
    The trellises of many lines in one launch: pads the (frames, classes)
    emissions and the token sequences into one batch, builds every trellis
    on `device` (the kernel of ``csrc/trellis.cu`` on a card, its plain
    version on the CPU) and copies them back at once. Each equals
    :func:`get_trellis` of its line bit for bit.
    """
    from kraken_tpu_torch.inference.recognition import resolve_device
    from kraken_tpu_torch.ops.trellis import blocks, pad, trellis
    if not emissions:
        return []
    args = pad(emissions, tokens, resolve_device(device))
    return blocks(trellis(*args).cpu().numpy(), args[2].tolist(), args[3].tolist())


def get_trellis_device(emission, tokens, device=None) -> torch.Tensor:
    """
    Device form of :func:`get_trellis` for one line: (frames, classes)
    emission and (tokens,) labels, numpy arrays or tensors, to the
    (frames+1, tokens+1) trellis as a tensor on `device` (by default the
    emission's device when it is a tensor, else the card). Bit-compatible
    with the numpy version.
    """
    from kraken_tpu_torch.inference.recognition import resolve_device
    from kraken_tpu_torch.ops.trellis import trellis
    if device is None:
        device = emission.device if isinstance(emission, torch.Tensor) else 'cuda'
    device = resolve_device(device)
    emission = torch.as_tensor(emission, dtype=torch.float32, device=device)
    tokens = torch.as_tensor(tokens, device=device).to(torch.int32)
    out = trellis(emission[None].contiguous(), tokens[None].contiguous(),
                  torch.tensor([emission.shape[0]], dtype=torch.int32, device=device),
                  torch.tensor([tokens.shape[0]], dtype=torch.int32, device=device))
    return out[0]


def backtrack(trellis: np.ndarray, emission: np.ndarray, tokens: np.ndarray) -> list[Point]:
    """Backtracks the best path through the trellis into per-frame points."""
    j = trellis.shape[1] - 1
    t_start = int(np.argmax(trellis[:, j]))
    path = []
    for t in range(t_start, 0, -1):
        stayed = trellis[t - 1, j] + emission[t - 1, 0]
        changed = trellis[t - 1, j - 1] + emission[t - 1, tokens[j - 1]]
        prob = float(np.exp(emission[t - 1, tokens[j - 1] if changed > stayed else 0]))
        path.append(Point(j - 1, t - 1, prob))
        if changed > stayed:
            j -= 1
            if j == 0:
                break
    else:
        raise ValueError('Failed to align')
    return path[::-1]


def merge_repeats(path: list[Point], ground_truth: str) -> list[Segment]:
    """Merges consecutive points of the same token into segments."""
    i1 = i2 = 0
    segments = []
    while i1 < len(path):
        while i2 < len(path) and path[i1].token_index == path[i2].token_index:
            i2 += 1
        score = sum(path[k].score for k in range(i1, i2)) / (i2 - i1)
        segments.append(Segment(ground_truth[path[i1].token_index],
                                path[i1].time_index,
                                path[i2 - 1].time_index + 1,
                                score))
        i1 = i2
    return segments


def prepare_line(logits: np.ndarray, codec, text: str,
                 base_dir: Optional[Literal['L', 'R']] = None):
    """
    What the trellis of one line needs: (display text, labels, (frames,
    classes) emission), or None when the output is too short for the
    encoded transcription or nothing of it is encodable.
    """
    do_text = get_display(text, base_dir=base_dir)
    labels = codec.encode(do_text).astype(np.int64)
    if len(labels) == 0 or logits.shape[-1] < 2 * len(labels):
        # nothing encodable (codec/transcription mismatch) or output too
        # short for the label sequence — no feasible alignment
        return None
    probs = logits.squeeze()
    # log-softmax over classes
    shifted = probs - probs.max(axis=0, keepdims=True)
    log_probs = shifted - np.log(np.exp(shifted).sum(axis=0, keepdims=True))
    return do_text, labels, log_probs.T


def align_line(logits: np.ndarray, codec, text: str,
               base_dir: Optional[Literal['L', 'R']] = None):
    """
    Aligns one line with the numpy trellis: returns (display text,
    segments) or None when the output is too short for the encoded
    transcription.
    """
    prepared = prepare_line(logits, codec, text, base_dir)
    if prepared is None:
        return None
    do_text, labels, emission = prepared
    trellis = get_trellis(emission, labels)
    path = backtrack(trellis, emission, labels)
    return do_text, merge_repeats(path, do_text)


def forced_align(doc: 'Segmentation', model: 'SeqRecognizer',
                 base_dir: Optional[Literal['L', 'R']] = None) -> 'Segmentation':
    """
    Aligns the transcriptions of a parsed document against recognition model
    activations, producing approximate character cut positions. The network
    runs where `model` was placed; each line's trellis is numpy's.
    """
    warnings.warn('`forced_align` is deprecated; use `ForcedAlignmentTaskModel` instead.',
                  DeprecationWarning)
    from kraken_tpu_torch import rpred as rpred_mod

    im = open_image(doc.imagename)
    predictor = rpred_mod.rpred(model, im, doc)

    records = []
    for idx, line in enumerate(doc.lines):
        next(predictor)
        # the reference feeds the softmax outputs straight into a log-softmax
        # (align.py:72); replicated here by passing them as pseudo-logits
        result = align_line(model.outputs[0], model.codec, line.text, base_dir)
        if result is None:
            logger.warning(f'Could not align line {idx}: output too short for transcription.')
            records.append(BaselineOCRRecord('', [], [], line))
            continue
        do_text, segments = result
        pred = ''.join(seg.label for seg in segments)
        pos = [(predictor._scale_val(seg.start, 0, predictor.box.size[0]),
                predictor._scale_val(seg.end, 0, predictor.box.size[0]))
               for seg in segments]
        conf = [seg.score for seg in segments]
        records.append(BaselineOCRRecord(pred, pos, conf, line, display_order=True))
    return replace(doc, lines=records)
