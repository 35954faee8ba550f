"""
kraken_tpu_torch.codec
~~~~~~~~~~~~~~~~~~~~~~

Many-to-many mapping between grapheme (cluster) strings and integer label
sequences for CTC networks.

Semantics match the reference engine's codec
(kraken/lib/codec.py): label 0 is the CTC blank, so all
labels are 1-indexed; automatically built codecs assign labels in sorted
grapheme order; manual mappings must form a prefix-free, non-singular code;
encoding greedily matches the longest grapheme sequence first; decoding
aggregates cut extents (min/max) and averages confidences across
multi-label code points.

Unlike the reference this codec is torch-free: `encode` returns an int32
numpy array ready to be fed to CTC losses.
"""
import logging
from collections import Counter
from collections.abc import Sequence
from typing import Union

import numpy as np

from kraken_tpu_torch.exceptions import KrakenCodecException, KrakenEncodeException

__all__ = ['Codec']

logger = logging.getLogger(__name__)


class Codec:
    """
    Builds a codec converting between graphemes/code points and integer
    label sequences.

    `charset` may be a string (each code point gets a label), a list of
    strings (each string gets a label), or a dict mapping strings to integer
    label sequences. In the first two cases labels are assigned automatically
    in sorted order starting at 1; manual mappings must be prefix-free in
    label space and non-singular in both directions.

    Args:
        charset: Input character set.
        strict: If True encoding/decoding errors raise exceptions instead of
                being skipped.

    Raises:
        KrakenCodecException: on duplicate entries or a non-singular /
                              non-prefix-free mapping.
    """

    def __init__(self, charset: Union[dict[str, Sequence[int]], Sequence[str], str], strict: bool = False):
        if isinstance(charset, dict):
            self.c2l = {k: list(v) for k, v in charset.items()}
        else:
            counts = Counter(charset)
            if len(counts) < len(charset):
                raise KrakenCodecException(f'Codec charset contains duplicate graphemes: {counts}')
            self.c2l = {char: [label] for label, char in enumerate(sorted(charset), start=1)}
        self.l2c: dict[tuple[int, ...], str] = {tuple(v): k for k, v in self.c2l.items()}
        self.l2c_single = {k[0]: v for k, v in self.l2c.items() if len(k) == 1}
        # character trie for longest-match encoding: each node is
        # {char: child, ...} with the label list of a complete grapheme
        # sequence stored under the None key.
        self._enc_trie: dict = {}
        for cseq, enc in self.c2l.items():
            node = self._enc_trie
            for ch in cseq:
                node = node.setdefault(ch, {})
            node[None] = enc
        # label trie for longest-match decoding of multi-label sequences
        self._dec_trie: dict = {}
        for lseq, cseq in self.l2c.items():
            node = self._dec_trie
            for label in lseq:
                node = node.setdefault(label, {})
            node[None] = cseq
        self.strict = strict
        if not self.is_valid:
            raise KrakenCodecException('Invalid codec: the label mapping must be non-singular and prefix-free.')

    def __len__(self) -> int:
        """Total number of label sequences the codec can decode."""
        return len(self.l2c)

    def __eq__(self, other) -> bool:
        return isinstance(other, Codec) and self.c2l == other.c2l

    def __repr__(self) -> str:
        return f'Codec({self.c2l})'

    @property
    def is_valid(self) -> bool:
        """
        True if the codec is prefix-free (in label space) and non-singular
        (in both directions).
        """
        if len(self.l2c) != len(self.c2l):
            return False
        codes = sorted(self.l2c.keys())
        for i, code_1 in enumerate(codes):
            for j, code_2 in enumerate(codes):
                if i != j and code_1[:len(code_2)] == code_2:
                    return False
        return True

    @property
    def max_label(self) -> int:
        """Maximum label value used by the codec."""
        return max(label for labels in self.c2l.values() for label in labels)

    def encode(self, s: str) -> np.ndarray:
        """
        Encodes a string into a label sequence, greedily matching the longest
        grapheme sequences first.

        Returns:
            int32 numpy array of labels.

        Raises:
            KrakenEncodeException: if a subsequence is not encodable and the
                                   codec is strict.
        """
        labels: list[int] = []
        n = len(s)
        idx = 0
        while idx < n:
            # walk the character trie to the deepest node that completes a
            # grapheme sequence (longest match wins)
            node = self._enc_trie
            best_enc = None
            best_len = 0
            depth = 0
            while idx + depth < n:
                node = node.get(s[idx + depth])
                if node is None:
                    break
                depth += 1
                enc = node.get(None)
                if enc is not None:
                    best_enc = enc
                    best_len = depth
            if best_enc is not None:
                labels.extend(best_enc)
                idx += best_len
            else:
                if self.strict:
                    raise KrakenEncodeException(f'No codec mapping for input starting at {s[idx:idx + 5]!r} (index {idx})')
                logger.warning(f'No codec mapping for input starting at {s[idx:idx + 5]!r} (index {idx}); skipping one code point')
                idx += 1
        return np.asarray(labels, dtype=np.int32)

    def decode(self, labels: Sequence[tuple[int, int, int, float]]) -> list[tuple[str, int, int, float]]:
        """
        Decodes a labelling into code points with positions and confidences.

        Multi-label code points aggregate the start of the first and end of
        the last label and average the confidences; multi-code-point labels
        replicate position/confidence onto every produced code point.

        Args:
            labels: sequence of tuples (label, start, end, confidence).

        Returns:
            list of tuples (code point, start, end, confidence).
        """
        starts = [x for _, x, _, _ in labels]
        ends = [x for _, _, x, _ in labels]
        confs = [x for _, _, _, x in labels]
        seq = tuple(int(x) for x, _, _, _ in labels)
        n = len(seq)
        decoded = []
        idx = 0
        while idx < n:
            code = self.l2c_single.get(seq[idx])
            if code is not None:
                decoded.extend((c, starts[idx], ends[idx], confs[idx]) for c in code)
                idx += 1
                continue
            # longest label-sequence match via the label trie; prefix-freedom
            # guarantees at most one complete sequence on the walked path
            node = self._dec_trie
            best_code = None
            best_len = 0
            depth = 0
            while idx + depth < n:
                node = node.get(seq[idx + depth])
                if node is None:
                    break
                depth += 1
                cseq = node.get(None)
                if cseq is not None:
                    best_code = cseq
                    best_len = depth
            if best_code is not None:
                conf = float(np.mean(confs[idx:idx + best_len]))
                end = ends[idx + best_len - 1]
                decoded.extend((c, starts[idx], end, conf) for c in best_code)
                idx += best_len
            else:
                if self.strict:
                    raise KrakenEncodeException(f'No codec mapping for labels starting at {seq[idx:idx + 5]} (index {idx})')
                logger.debug(f'No codec mapping for labels starting at {seq[idx:idx + 5]} (index {idx}); skipping one label')
                idx += 1
        return decoded

    def merge(self, codec: 'Codec') -> tuple['Codec', set]:
        """
        Transforms this codec (c1) into another (c2), reusing as many labels
        as possible.

        The resulting codec encodes the same code point sequences as c2 while
        retaining matching grapheme→label mappings from c1. Mappings of c1
        absent from c2 are removed (unless their labels are still used by
        retained mappings), remaining labels are compacted to close holes, and
        mappings only in c2 are appended with fresh labels.

        Returns:
            (merged codec, set of labels removed from c1).
        """
        rm_candidates = {cseq: enc for cseq, enc in self.c2l.items() if cseq not in codec.c2l}
        merged = {k: list(v) for k, v in self.c2l.items() if k not in rm_candidates}
        # labels still used by retained mappings must not be removed
        rm_labels = [label for v in rm_candidates.values() for label in v]
        for v in merged.values():
            for label in rm_labels:
                if label in v:
                    rm_labels.remove(label)
        # iteratively remove labels, decrementing subsequent labels to close holes
        offset_rm_labels = [v - idx for idx, v in enumerate(sorted(set(rm_labels)))]
        for rlabel in offset_rm_labels:
            merged = {k: [label - 1 if label > rlabel else label for label in v] for k, v in merged.items()}
        # append mappings only present in the other codec with fresh labels
        add_list = {cseq: enc for cseq, enc in codec.c2l.items() if cseq not in self.c2l}
        start_idx = max((0,) + tuple(label for v in merged.values() for label in v)) + 1
        relabel = {old: new for new, old in enumerate(sorted(set(label for v in add_list.values() for label in v)), start_idx)}
        for k, v in add_list.items():
            merged[k] = [relabel[label] for label in v]
        return Codec(merged, self.strict), set(rm_labels)

    def add_labels(self, charset: Union[dict[str, Sequence[int]], Sequence[str], str]) -> 'Codec':
        """
        Returns a new codec with additional characters/labels appended.

        Automatic label assignment continues from `max_label + 1` in sorted
        order of the new charset.
        """
        c2l = {k: list(v) for k, v in self.c2l.items()}
        if isinstance(charset, dict):
            c2l.update({k: list(v) for k, v in charset.items()})
        else:
            c2l.update({char: [label] for label, char in enumerate(sorted(charset), start=self.max_label + 1)})
        return Codec(c2l, self.strict)
