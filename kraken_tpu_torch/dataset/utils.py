"""
kraken_tpu_torch.dataset.utils
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Batch collation and evaluation-report helpers (reference:
kraken/lib/dataset/utils.py:284-392), a copy of the JAX package's
``dataset/utils.py`` with its script table (``_scripts_ranges.json``).
"""
from collections import Counter
from collections.abc import Sequence
from functools import lru_cache
from typing import Any, Optional

import numpy as np

__all__ = ['collate_sequences', 'global_align', 'compute_confusions', '_get_type']


def _get_type(tags: dict, default: str = 'default') -> str:
    if tags is None:
        return default
    ot = tags.get('type', [{'type': default}])[0]
    tt = ot.get('type')
    return tt if tt is not None else default


def collate_sequences(batch: list[dict]) -> dict:
    """
    Sorts a batch of line samples by width (descending) and pads images and
    targets into dense arrays.

    Each sample is a dict with 'image' (C, H, W numpy array) and 'target'
    (string or integer label array).
    """
    sorted_batch = sorted(batch, key=lambda x: x['image'].shape[2], reverse=True)
    seqs = [x['image'] for x in sorted_batch]
    seq_lens = np.array([seq.shape[2] for seq in seqs], np.int64)
    max_len = seqs[0].shape[2]
    images = np.stack([np.pad(seq, ((0, 0), (0, 0), (0, max_len - seq.shape[2]))) for seq in seqs])
    if isinstance(sorted_batch[0]['target'], str):
        labels = [x['target'] for x in sorted_batch]
    else:
        labels = np.concatenate([np.asarray(x['target']) for x in sorted_batch]).astype(np.int64)
    label_lens = np.array([len(x['target']) for x in sorted_batch], np.int64)
    return {'image': images, 'target': labels, 'seq_lens': seq_lens, 'target_lens': label_lens}


def global_align(seq1: Sequence[Any], seq2: Sequence[Any]) -> tuple[int, list[str], list[str]]:
    """
    Levenshtein global alignment of two sequences via dynamic programming
    with backtrace, returning (distance, aligned seq1, aligned seq2) where
    gaps are empty strings.
    """
    n, m = len(seq1), len(seq2)
    cost = np.zeros((n + 1, m + 1), np.int32)
    cost[:, 0] = np.arange(n + 1)
    cost[0, :] = np.arange(m + 1)
    # 0 = diag, 1 = up (deletion), 2 = left (insertion)
    move = np.zeros((n + 1, m + 1), np.int8)
    move[1:, 0] = 1
    move[0, 1:] = 2
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            sub = cost[i - 1, j - 1] + (seq1[i - 1] != seq2[j - 1])
            dele = cost[i - 1, j] + 1
            ins = cost[i, j - 1] + 1
            best = min(sub, dele, ins)
            cost[i, j] = best
            move[i, j] = 0 if best == sub else (1 if best == dele else 2)
    algn1: list[Any] = []
    algn2: list[Any] = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and move[i, j] == 0:
            algn1.insert(0, seq1[i - 1])
            algn2.insert(0, seq2[j - 1])
            i -= 1
            j -= 1
        elif i > 0 and (j == 0 or move[i, j] == 1):
            algn1.insert(0, seq1[i - 1])
            algn2.insert(0, '')
            i -= 1
        else:
            algn1.insert(0, '')
            algn2.insert(0, seq2[j - 1])
            j -= 1
    return int(cost[n, m]), algn1, algn2


# Script identification for per-script error attribution: exact UCD Script
# property ranges (from the regex module's bundled Unicode tables) in
# _scripts_ranges.json, the JAX package's table. The reference uses the
# same range-table approach (kraken/lib/dataset/utils.py:333 + scripts.json).
_SCRIPT_RANGES: Optional[tuple[list[int], list[tuple[int, int, str]]]] = None


def _load_script_ranges():
    global _SCRIPT_RANGES
    if _SCRIPT_RANGES is None:
        import json
        from pathlib import Path
        table = json.loads((Path(__file__).parent / '_scripts_ranges.json').read_text())
        # single-codepoint ranges store a null end
        _SCRIPT_RANGES = ([row[0] for row in table],
                          [(row[0], row[1] if row[1] is not None else row[0], row[2])
                           for row in table])
    return _SCRIPT_RANGES


@lru_cache(maxsize=4096)
def _get_script(char: str) -> str:
    """Unicode Script property of a code point ('Unknown' for unassigned)."""
    import bisect
    try:
        cp = ord(char)
    except TypeError:
        return 'Unknown'
    starts, rows = _load_script_ranges()
    i = bisect.bisect_right(starts, cp) - 1
    if i >= 0 and rows[i][0] <= cp <= rows[i][1]:
        return rows[i][2]
    return 'Unknown'


def compute_confusions(algn1: Sequence[str], algn2: Sequence[str]):
    """
    Confusion statistics from two globally aligned sequences.

    Returns:
        (counts, scripts, ins, dels, subs): per-pair confusion counts,
        per-script totals, insertion count, per-script deletions, per-script
        substitutions.
    """
    counts: dict[tuple[str, str], int] = Counter()
    scripts: dict[str, int] = Counter()
    ins = 0
    dels: dict[str, int] = Counter()
    subs: dict[str, int] = Counter()
    for u, v in zip(algn1, algn2):
        counts[(u, v)] += 1
    for (u, v), n in counts.items():
        if u == '':
            ins += n
        else:
            script = _get_script(u[0]) if u else 'Unknown'
            scripts[script] += n
            if v == '':
                dels[script] += n
            elif u != v:
                subs[script] += n
    return counts, scripts, ins, dels, subs
