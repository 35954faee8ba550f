"""
kraken_tpu_torch.lib.bidi
~~~~~~~~~~~~~~~~~~~~~~~~~

Implementation of the Unicode Bidirectional Algorithm (UAX #9), written from
the specification. Provides the same public surface as the reference engine's
bidi package (kraken/lib/bidi/__init__.py:461,505): a
``get_display`` returning the display-ordered string and ``get_display_map``
additionally returning the logical index of every display character, which the
OCR records use to reorder per-character cuts and confidences.

Character data: Bidi_Class comes from Python's ``unicodedata`` module (host
UCD version — characters assigned after it resolve through the @missing
default ranges of DerivedBidiClass.txt below). Mirroring (L4) and paired
brackets (BD14-16) merge two sources: pairs reconstructed by LEFT↔RIGHT (and
LESS-THAN↔GREATER-THAN etc.) name transposition over all code points with
the ``Bidi_Mirrored`` property, plus the checked-in UCD 17.0 supplement
``_bidi_tables.json`` for the ~37% of pairs whose names do not transpose
(regenerate with contrib/generate_bidi_tables.py). The merged tables are
fuzz-pinned against an independent UBA implementation (tests/test_bidi.py).

Rules P1 (paragraph splitting) and L3 (combining marks) are out of scope, as
in the reference: input is always a single line of text.
"""
import sys
import unicodedata
from functools import lru_cache
from typing import Literal, Optional

__all__ = ['get_display', 'get_display_map', 'bidi_class', 'UCD_VERSION']

UCD_VERSION = unicodedata.unidata_version

MAX_DEPTH = 125           # BD2: maximum explicit embedding depth
MAX_PAIRING_DEPTH = 63    # BD16: bracket-pair stack limit

_ISOLATE_INITIATORS = frozenset(('LRI', 'RLI', 'FSI'))
_EXPLICIT = frozenset(('RLE', 'LRE', 'RLO', 'LRO'))
_REMOVED_BY_X9 = frozenset(('RLE', 'LRE', 'RLO', 'LRO', 'PDF', 'BN'))
_NI = frozenset(('B', 'S', 'WS', 'ON', 'LRI', 'RLI', 'FSI', 'PDI'))
_STRONG = frozenset(('L', 'R', 'AL'))

# default Bidi_Class ranges for unassigned code points, per the @missing
# declarations in DerivedBidiClass.txt (UCD). unicodedata.bidirectional()
# returns '' for unassigned code points, so these provide the fallback.
_DEFAULT_RANGES = (
    (0x0600, 0x07BF, 'AL'), (0x0860, 0x08FF, 'AL'),
    (0xFB50, 0xFDCF, 'AL'), (0xFDF0, 0xFDFF, 'AL'),
    (0xFE70, 0xFEFF, 'AL'),
    (0x0590, 0x05FF, 'R'), (0x07C0, 0x085F, 'R'),
    (0xFB1D, 0xFB4F, 'R'),
    (0x10800, 0x10CFF, 'R'), (0x10D40, 0x10EBF, 'R'),
    (0x10F00, 0x10F2F, 'R'), (0x10F70, 0x10FFF, 'R'),
    (0x1E800, 0x1EC6F, 'R'), (0x1ECC0, 0x1ECFF, 'R'),
    (0x1ED50, 0x1EDFF, 'R'), (0x1EF00, 0x1EFFF, 'R'),
    (0x10D00, 0x10D3F, 'AL'), (0x10EC0, 0x10EFF, 'AL'),
    (0x10F30, 0x10F6F, 'AL'), (0x1EC70, 0x1ECBF, 'AL'),
    (0x1ED00, 0x1ED4F, 'AL'), (0x1EE00, 0x1EEFF, 'AL'),
    (0x20A0, 0x20CF, 'ET'),
)


@lru_cache(maxsize=None)
def bidi_class(codepoint: int) -> str:
    """
    Returns the Bidi_Class of a code point, with DerivedBidiClass.txt
    default ranges for unassigned code points.
    """
    cls = unicodedata.bidirectional(chr(codepoint))
    if cls:
        return cls
    for start, end, default in _DEFAULT_RANGES:
        if start <= codepoint <= end:
            return default
    return 'L'


def _name_mirror(cp: int) -> Optional[int]:
    """
    Finds the mirror glyph of a code point by transposing directional terms
    in its character name and looking the transposed name back up.
    """
    try:
        name = unicodedata.name(chr(cp))
    except ValueError:
        return None
    for a, b in (('LEFT-POINTING', 'RIGHT-POINTING'),
                 ('LEFT ', 'RIGHT '), ('LEFT-', 'RIGHT-'),
                 ('LESS-THAN', 'GREATER-THAN'),
                 ('SMALLER THAN', 'GREATER THAN'),
                 ('PRECED', 'SUCCEED'), ('SUBSET', 'SUPERSET'),
                 ('SUBGROUP', 'SUPERGROUP')):
        swapped = None
        if a in name and b not in name:
            swapped = name.replace(a, b)
        elif b in name and a not in name:
            swapped = name.replace(b, a)
        if swapped is not None and swapped != name:
            try:
                mirror = ord(unicodedata.lookup(swapped))
            except KeyError:
                continue
            if unicodedata.mirrored(chr(mirror)):
                return mirror
    return None


def _derive_name_mirrors() -> dict[int, int]:
    """The self-derived part of the mirroring map (L4): name transposition
    over all code points with the Bidi_Mirrored property."""
    mirrored: dict[int, int] = {}
    for cp in range(sys.maxunicode + 1):
        if not unicodedata.mirrored(chr(cp)):
            continue
        mirror = _name_mirror(cp)
        if mirror is not None:
            mirrored[cp] = mirror
    return mirrored


def _build_tables() -> tuple[dict[int, int], dict[int, int], dict[int, int]]:
    """
    Builds the mirroring map (L4) and the canonical open→close /
    close→open bracket pair maps (BD14-BD16): name-transposition pairs
    from unicodedata merged with the checked-in UCD supplement
    (_bidi_tables.json; see contrib/generate_bidi_tables.py).
    """
    import json
    import pathlib
    mirrored = _derive_name_mirrors()
    open_to_close: dict[int, int] = {}
    close_to_open: dict[int, int] = {}
    tables = pathlib.Path(__file__).parent / '_bidi_tables.json'
    if tables.exists():
        data = json.loads(tables.read_text())
        for a, b in data['mirror_supplement']:
            mirrored[a] = b
        for a, b, typ in data['brackets']:
            if typ == 'o':
                open_to_close[a] = b
            else:
                close_to_open[a] = b
    else:                                   # heuristic-only fallback
        for cp, mirror in mirrored.items():
            if unicodedata.category(chr(cp)) == 'Ps' \
                    and unicodedata.category(chr(mirror)) == 'Pe':
                open_to_close[cp] = mirror
                close_to_open[mirror] = cp
    return mirrored, open_to_close, close_to_open


MIRRORED, _BRACKET_OPEN, _BRACKET_CLOSE = _build_tables()

# canonical equivalences for bracket matching (BD16)
_CANON = {0x3008: 0x2329, 0x3009: 0x232A}


def _canon_bracket(cp: int) -> int:
    return _CANON.get(cp, cp)


def _embedding_direction(level: int) -> str:
    return 'R' if level % 2 else 'L'


def _match_isolates(types: list[str]) -> dict[int, int]:
    """
    BD9: computes the matching PDI for every isolate initiator. Initiators
    without a matching PDI map to len(types).
    """
    matches: dict[int, int] = {}
    stack: list[int] = []
    for i, t in enumerate(types):
        if t in _ISOLATE_INITIATORS:
            stack.append(i)
        elif t == 'PDI' and stack:
            matches[stack.pop()] = i
    for i in stack:
        matches[i] = len(types)
    return matches


def _first_strong_level(types: list[str], start: int, end: int) -> int:
    """
    P2/P3 (also X5c): finds the paragraph embedding level of the first strong
    type in types[start:end], skipping isolated runs.
    """
    depth = 0
    for t in types[start:end]:
        if t in _ISOLATE_INITIATORS:
            depth += 1
        elif t == 'PDI':
            if depth > 0:
                depth -= 1
        elif depth == 0:
            if t == 'L':
                return 0
            if t in ('R', 'AL'):
                return 1
    return 0


def _explicit_levels(types: list[str], para_level: int,
                     matching_pdi: dict[int, int]) -> list[int]:
    """
    X1-X8: resolves explicit embedding levels and applies directional
    overrides (mutating `types` for overridden characters).
    """
    n = len(types)
    levels = [para_level] * n
    # stack of (embedding level, override status, isolate status)
    stack: list[tuple[int, Optional[str], bool]] = [(para_level, None, False)]
    overflow_isolates = 0
    overflow_embeddings = 0
    valid_isolates = 0
    for i, t in enumerate(types):
        if t in _EXPLICIT:
            # X2-X5
            levels[i] = stack[-1][0]
            new_level = ((stack[-1][0] + 1) | 1) if t in ('RLE', 'RLO') else ((stack[-1][0] + 2) & ~1)
            if new_level <= MAX_DEPTH and overflow_isolates == 0 and overflow_embeddings == 0:
                override = t[0] if t.endswith('O') else None
                stack.append((new_level, override, False))
            elif overflow_isolates == 0:
                overflow_embeddings += 1
        elif t in _ISOLATE_INITIATORS:
            # X5a-X5c
            if t == 'FSI':
                first_strong = _first_strong_level(types, i + 1, matching_pdi.get(i, n))
                rtl = first_strong == 1
            else:
                rtl = t == 'RLI'
            levels[i] = stack[-1][0]
            if stack[-1][1] is not None:
                types[i] = stack[-1][1]
            new_level = ((stack[-1][0] + 1) | 1) if rtl else ((stack[-1][0] + 2) & ~1)
            if new_level <= MAX_DEPTH and overflow_isolates == 0 and overflow_embeddings == 0:
                valid_isolates += 1
                stack.append((new_level, None, True))
            else:
                overflow_isolates += 1
        elif t == 'PDI':
            # X6a
            if overflow_isolates > 0:
                overflow_isolates -= 1
            elif valid_isolates > 0:
                overflow_embeddings = 0
                while not stack[-1][2]:
                    stack.pop()
                stack.pop()
                valid_isolates -= 1
            levels[i] = stack[-1][0]
            if stack[-1][1] is not None:
                types[i] = stack[-1][1]
        elif t == 'PDF':
            # X7
            levels[i] = stack[-1][0]
            if overflow_isolates > 0:
                pass
            elif overflow_embeddings > 0:
                overflow_embeddings -= 1
            elif not stack[-1][2] and len(stack) > 1:
                stack.pop()
        elif t == 'B':
            # X8
            levels[i] = para_level
        else:
            # X6
            levels[i] = stack[-1][0]
            if stack[-1][1] is not None:
                types[i] = stack[-1][1]
    return levels


class _IsolatingRunSequence:
    """
    An isolating run sequence (BD13) over the X9-filtered index list, with
    sos/eos types per X10.
    """

    def __init__(self, indices: list[int], types: list[str], levels: list[int],
                 para_level: int, n: int):
        self.indices = indices
        self.types = [types[i] for i in indices]
        self.level = levels[indices[0]]
        # sos: compare with level of last non-removed char before the sequence
        prev_level = para_level
        for j in range(indices[0] - 1, -1, -1):
            if types[j] not in _REMOVED_BY_X9:
                prev_level = levels[j]
                break
        self.sos = _embedding_direction(max(self.level, prev_level))
        # eos: if the sequence ends with an unmatched isolate initiator, eos
        # uses the paragraph level, else the level of the next non-removed char
        last = indices[-1]
        if types[last] in _ISOLATE_INITIATORS:
            next_level = para_level
        else:
            next_level = para_level
            for j in range(last + 1, n):
                if types[j] not in _REMOVED_BY_X9:
                    next_level = levels[j]
                    break
        self.eos = _embedding_direction(max(self.level, next_level))


def _isolating_run_sequences(kept: list[int], types: list[str],
                             levels: list[int], para_level: int,
                             matching_pdi: dict[int, int]) -> list[_IsolatingRunSequence]:
    """
    BD13/X10: partitions the level runs (over X9-surviving characters) into
    isolating run sequences.
    """
    n = len(types)
    # level runs over kept indices
    runs: list[list[int]] = []
    for idx in kept:
        if runs and levels[idx] == levels[runs[-1][-1]]:
            runs[-1].append(idx)
        else:
            runs.append([idx])
    run_of: dict[int, int] = {}
    for ri, run in enumerate(runs):
        for idx in run:
            run_of[idx] = ri
    used = set()
    sequences = []
    for ri, run in enumerate(runs):
        if ri in used:
            continue
        first = run[0]
        # a run starting with a PDI that matches an initiator belongs to that
        # initiator's sequence
        if types[first] == 'PDI' and any(m == first for m in matching_pdi.values()):
            continue
        seq = list(run)
        used.add(ri)
        while types[seq[-1]] in _ISOLATE_INITIATORS:
            pdi = matching_pdi.get(seq[-1], n)
            if pdi >= n or pdi not in run_of:
                break
            nri = run_of[pdi]
            if nri in used:
                break
            seq.extend(runs[nri])
            used.add(nri)
        sequences.append(_IsolatingRunSequence(seq, types, levels, para_level, n))
    return sequences


def _resolve_weak(seq: _IsolatingRunSequence) -> None:
    """W1-W7 on one isolating run sequence."""
    types = seq.types
    n = len(types)
    # W1: NSM takes the type of the previous character (sos at start;
    # isolates and PDI yield ON)
    prev = seq.sos
    for i in range(n):
        if types[i] == 'NSM':
            types[i] = 'ON' if prev in _ISOLATE_INITIATORS or prev == 'PDI' else prev
        prev = types[i]
    # W2: EN → AN if the last strong type before it is AL
    strong = seq.sos
    for i in range(n):
        if types[i] in _STRONG:
            strong = types[i]
        elif types[i] == 'EN' and strong == 'AL':
            types[i] = 'AN'
    # W3: AL → R
    for i in range(n):
        if types[i] == 'AL':
            types[i] = 'R'
    # W4: single ES between EN becomes EN; single CS between same numbers
    for i in range(1, n - 1):
        if types[i] == 'ES' and types[i - 1] == 'EN' and types[i + 1] == 'EN':
            types[i] = 'EN'
        elif types[i] == 'CS' and types[i - 1] == types[i + 1] and types[i - 1] in ('EN', 'AN'):
            types[i] = types[i - 1]
    # W5: a sequence of ET adjacent to EN becomes EN
    i = 0
    while i < n:
        if types[i] == 'ET':
            j = i
            while j < n and types[j] == 'ET':
                j += 1
            before = types[i - 1] if i > 0 else seq.sos
            after = types[j] if j < n else seq.eos
            if before == 'EN' or after == 'EN':
                for k in range(i, j):
                    types[k] = 'EN'
            i = j
        else:
            i += 1
    # W6: remaining ET/ES/CS → ON
    for i in range(n):
        if types[i] in ('ET', 'ES', 'CS'):
            types[i] = 'ON'
    # W7: EN → L if last strong type is L
    strong = seq.sos
    for i in range(n):
        if types[i] in ('L', 'R'):
            strong = types[i]
        elif types[i] == 'EN' and strong == 'L':
            types[i] = 'L'


def _resolve_brackets(seq: _IsolatingRunSequence, cps: list[int]) -> None:
    """N0/BD16: resolves paired brackets to strong types."""
    types = seq.types
    e = _embedding_direction(seq.level)
    o = 'R' if e == 'L' else 'L'
    # BD16: find bracket pairs with a stack
    stack: list[tuple[int, int]] = []  # (canonical open cp, position in seq)
    pairs: list[tuple[int, int]] = []
    for i, idx in enumerate(seq.indices):
        if types[i] != 'ON':
            continue
        cp = cps[idx]
        if cp in _BRACKET_OPEN:
            if len(stack) >= MAX_PAIRING_DEPTH:
                break
            stack.append((_canon_bracket(cp), i))
        elif cp in _BRACKET_CLOSE:
            target = _canon_bracket(_BRACKET_CLOSE[cp])
            for si in range(len(stack) - 1, -1, -1):
                if stack[si][0] == target:
                    pairs.append((stack[si][1], i))
                    del stack[si:]
                    break
    pairs.sort()
    for open_i, close_i in pairs:
        # strong types inside the pair
        has_e = False
        has_o = False
        for i in range(open_i + 1, close_i):
            t = types[i]
            if t in ('EN', 'AN'):
                t = 'R'
            if t == e:
                has_e = True
            elif t == o:
                has_o = True
        if has_e:
            new_type = e
        elif has_o:
            # check preceding context
            context = seq.sos
            for i in range(open_i - 1, -1, -1):
                t = types[i]
                if t in ('EN', 'AN'):
                    t = 'R'
                if t in ('L', 'R'):
                    context = t
                    break
            new_type = o if context == o else e
        else:
            continue
        types[open_i] = new_type
        types[close_i] = new_type
        # N0 trailing rule: NSMs following a resolved bracket take its type.
        # (NSM types were rewritten by W1, so consult the original classes.)
        for i in range(close_i + 1, len(types)):
            if bidi_class(cps[seq.indices[i]]) == 'NSM':
                types[i] = new_type
            else:
                break
        for i in range(open_i + 1, len(types)):
            if bidi_class(cps[seq.indices[i]]) == 'NSM':
                types[i] = new_type
            else:
                break


def _resolve_neutrals(seq: _IsolatingRunSequence) -> None:
    """N1-N2: resolves remaining neutral and isolate formatting types."""
    types = seq.types
    n = len(types)
    e = _embedding_direction(seq.level)
    i = 0
    while i < n:
        if types[i] in _NI:
            j = i
            while j < n and types[j] in _NI:
                j += 1
            before = types[i - 1] if i > 0 else seq.sos
            after = types[j] if j < n else seq.eos
            if before in ('EN', 'AN'):
                before = 'R'
            if after in ('EN', 'AN'):
                after = 'R'
            new_type = before if before == after and before in ('L', 'R') else e
            for k in range(i, j):
                types[k] = new_type
            i = j
        else:
            i += 1


def _resolve_implicit(seq: _IsolatingRunSequence, levels: list[int]) -> None:
    """I1-I2: assigns implicit embedding levels."""
    for i, idx in enumerate(seq.indices):
        t = seq.types[i]
        level = seq.level
        if level % 2 == 0:
            if t == 'R':
                level += 1
            elif t in ('AN', 'EN'):
                level += 2
        else:
            if t in ('L', 'AN', 'EN'):
                level += 1
        levels[idx] = level


def _reorder(levels: list[int], kept: list[int]) -> list[int]:
    """L2: reverse contiguous runs from the highest level down to the lowest odd."""
    visual = list(kept)
    if not visual:
        return visual
    highest = max(levels[i] for i in visual)
    lowest_odd = min((levels[i] for i in visual if levels[i] % 2), default=None)
    if lowest_odd is None:
        return visual
    for level in range(highest, lowest_odd - 1, -1):
        k = 0
        while k < len(visual):
            if levels[visual[k]] >= level:
                j = k
                while j < len(visual) and levels[visual[j]] >= level:
                    j += 1
                visual[k:j] = visual[k:j][::-1]
                k = j
            else:
                k += 1
    return visual


def get_display_map(text: str,
                    base_dir: Optional[Literal['L', 'R']] = None) -> tuple[str, list[int]]:
    """
    Reorders a string from logical into display order (UAX #9, single
    paragraph).

    Args:
        text: Text in logical order.
        base_dir: Base (paragraph) direction, 'L' or 'R'. When None the
                  direction is resolved from the first strong character
                  (P2/P3).

    Returns:
        Tuple of the display-ordered string and, for each of its characters,
        the index into ``text`` it came from. Mirrored characters in
        right-to-left runs are replaced by their mirror image; explicit
        directional formatting characters and BN-class characters are removed.
    """
    if base_dir not in (None, 'L', 'R'):
        raise ValueError(f'Invalid base direction {base_dir!r}')
    cps = [ord(ch) for ch in text]
    orig_types = [bidi_class(cp) for cp in cps]
    types = list(orig_types)
    para_level = (_first_strong_level(types, 0, len(types))
                  if base_dir is None else (0 if base_dir == 'L' else 1))
    matching_pdi = _match_isolates(types)
    levels = _explicit_levels(types, para_level, matching_pdi)
    # X9: indices surviving removal of explicit formatting characters and BN
    kept = [i for i, t in enumerate(orig_types) if t not in _REMOVED_BY_X9]
    if kept:
        for seq in _isolating_run_sequences(kept, types, levels, para_level, matching_pdi):
            _resolve_weak(seq)
            _resolve_brackets(seq, cps)
            _resolve_neutrals(seq)
            _resolve_implicit(seq, levels)
    # L1: segment separators, paragraph separators, and any preceding
    # whitespace/isolates reset to the paragraph level; same for trailing
    # whitespace at the end of the line
    reset_candidate = True
    for i in range(len(cps) - 1, -1, -1):
        t = orig_types[i]
        if t in ('B', 'S'):
            levels[i] = para_level
            reset_candidate = True
        elif reset_candidate and t in ('WS', 'LRI', 'RLI', 'FSI', 'PDI'):
            levels[i] = para_level
        elif t not in _REMOVED_BY_X9:
            reset_candidate = False
    visual = _reorder(levels, kept)
    display = []
    order = []
    for i in visual:
        if orig_types[i] in _ISOLATE_INITIATORS or orig_types[i] == 'PDI':
            continue
        cp = cps[i]
        # L4: mirrored glyphs in RTL runs
        if levels[i] % 2 and cp in MIRRORED:
            cp = MIRRORED[cp]
        display.append(chr(cp))
        order.append(i)
    return ''.join(display), order


def get_display(text: str, base_dir: Optional[Literal['L', 'R']] = None) -> str:
    """
    Reorders a string from logical into display order (UAX #9, single
    paragraph). See :func:`get_display_map`.
    """
    return get_display_map(text, base_dir)[0]
