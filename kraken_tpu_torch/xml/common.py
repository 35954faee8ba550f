"""
Shared helpers for ALTO/PageXML parsing: coordinate string parsing,
Transkribus `custom` attribute parsing, reading-order group traversal, and
order flattening/validation (reference: kraken/lib/xml/common.py).
"""
import logging
import re
from collections import defaultdict
from itertools import groupby
from typing import Optional

logger = logging.getLogger(__name__)

# region element → default type tag
PAGE_REGIONS = {'TextRegion': 'text',
                'ImageRegion': 'image',
                'LineDrawingRegion': 'line drawing',
                'GraphicRegion': 'graphic',
                'TableRegion': 'table',
                'ChartRegion': 'chart',
                'MapRegion': 'map',
                'SeparatorRegion': 'separator',
                'MathsRegion': 'maths',
                'ChemRegion': 'chem',
                'MusicRegion': 'music',
                'AdvertRegion': 'advert',
                'NoiseRegion': 'noise',
                'UnknownRegion': 'unknown',
                'CustomRegion': 'custom'}

ALTO_REGIONS = {'TextBlock': 'text',
                'Illustration': 'illustration',
                'GraphicalElement': 'graphic',
                'ComposedBlock': 'composed'}

_FLOAT_RE = re.compile(r'[-+]?(\d+(\.\d*)?|\.\d+)([eE][-+]?\d+)?')


def parse_alto_pointstype(coords: str) -> list[tuple[int, int]]:
    """
    Parses ALTO's underspecified PointsType: any of
    `x0,y0 x1,y1`, `x0 y0 x1 y1`, `(x0,y0) (x1,y1)`, `(x0 y0) (x1 y1)`.
    Consecutive duplicate points are collapsed.
    """
    try:
        values = [int(float(m.group())) for m in _FLOAT_RE.finditer(coords)]
    except (ValueError, TypeError):
        raise ValueError(f'Unparseable points attribute: {coords}')
    if len(values) % 2:
        raise ValueError(f'Points attribute has an odd coordinate count: {values}')
    return [pt for pt, _ in groupby(zip(values[::2], values[1::2]))]


def parse_page_coords(coords: str) -> list[tuple[int, int]]:
    """Parses PageXML `x0,y0 x1,y1 ...` point strings."""
    values = [int(c) for point in coords.split(' ') for c in point.split(',')]
    return [pt for pt, _ in groupby(zip(values[::2], values[1::2]))]


def parse_page_custom(s: str) -> dict[str, list[dict[str, str]]]:
    """
    Parses a Transkribus-style `custom` attribute
    (`tag {key:value; ...} tag2 {...}`) into a dict of tag → list of
    key/value dicts.
    """
    out = defaultdict(list)
    for chunk in s.strip().split('}'):
        if not chunk.strip():
            continue
        tag, _, body = chunk.partition('{')
        entries = {}
        for item in body.split(';'):
            item = item.strip()
            if not item:
                continue
            key, _, value = item.partition(':')
            entries[key.strip()] = value.strip()
        out[tag.strip()].append(entries)
    return dict(out)


def parse_reading_order_groups(ro_el, ref_attr: str):
    """
    Traverses an ALTO/PageXML ReadingOrder element into raw ID orders.

    A single top-level UnorderedGroup is unwrapped into multiple independent
    (partial) orders. Nested UnorderedGroups are flattened in document order
    with a warning.

    Returns:
        list of (element, raw order id list, is_total) triples.
    """
    groups = list(ro_el)
    if len(groups) == 1 and groups[0].tag.endswith('UnorderedGroup'):
        groups = list(groups[0])

    def _collect(el):
        if el.tag.endswith('UnorderedGroup'):
            logger.warning('Reading order nests an UnorderedGroup; '
                           'flattening to document order.')
            refs = []
            for child in el:
                sub = _collect(child)
                refs.extend(sub) if isinstance(sub, list) else refs.append(sub)
            return refs
        if el.tag.endswith('OrderedGroup'):
            refs = []
            for child in el:
                sub = _collect(child)
                refs.extend(sub) if isinstance(sub, list) else refs.append(sub)
            return refs
        return el.get(ref_attr)

    orders = []
    for group in groups:
        raw = _collect(group)
        if isinstance(raw, str):
            raw = [raw]
        parent = group.getparent()
        is_total = not (parent is not None and parent.tag.endswith('UnorderedGroup'))
        orders.append((group, raw, is_total))
    return orders


def flatten_order_to_lines(raw_order: list[str],
                           lines: dict,
                           region_ids: set[str],
                           line_implicit_order: list[str],
                           string_to_line: Optional[dict[str, str]] = None,
                           missing_region_ids: Optional[set[str]] = None) -> list[str]:
    """
    Resolves a raw order of mixed line/region/String IDs to line IDs:
    regions expand to their lines in implicit order, ALTO String IDs map to
    their parent line (deduplicating consecutive repeats), unknown IDs are
    skipped.
    """
    result = []
    for ref in raw_order:
        if ref in lines:
            result.append(ref)
        elif ref in region_ids:
            result.extend(lid for lid in line_implicit_order
                          if lines[lid].regions and lines[lid].regions[0] == ref)
        elif missing_region_ids and ref in missing_region_ids:
            logger.warning(f'Reading order points at region {ref} that has no coordinates; skipped.')
        elif string_to_line and ref in string_to_line:
            parent = string_to_line[ref]
            if not result or result[-1] != parent:
                result.append(parent)
        else:
            logger.info(f'Unknown element ID {ref} named in the reading order; skipped.')
    return result


def flatten_order_to_regions(raw_order: list[str],
                             lines: dict,
                             region_ids: set[str],
                             string_to_line: Optional[dict[str, str]] = None,
                             missing_region_ids: Optional[set[str]] = None) -> list[str]:
    """
    Resolves a raw order of mixed IDs to region IDs: line and String IDs map
    to their containing region (deduplicating consecutive repeats).
    """
    result = []

    def _push_region(rid):
        if rid and (not result or result[-1] != rid):
            result.append(rid)

    for ref in raw_order:
        if ref in region_ids:
            _push_region(ref)
        elif missing_region_ids and ref in missing_region_ids:
            logger.warning(f'Reading order points at region {ref} that has no coordinates; skipped.')
        elif ref in lines:
            _push_region(lines[ref].regions[0] if lines[ref].regions else None)
        elif string_to_line and ref in string_to_line:
            parent = string_to_line[ref]
            if parent in lines:
                _push_region(lines[parent].regions[0] if lines[parent].regions else None)
        else:
            logger.info(f'Unknown element ID {ref} named in the reading order; skipped.')
    return result


def validate_and_clean_order(order: list[str], valid_ids: set[str]) -> tuple[list[str], bool]:
    """Drops unknown and duplicate IDs; returns (cleaned, was_clean)."""
    cleaned = []
    seen = set()
    clean = True
    for ref in order:
        if ref not in valid_ids:
            logger.info(f'ID {ref} listed in the reading order but absent from the document; dropped.')
            clean = False
        elif ref in seen:
            logger.info(f'Duplicate ID {ref} repeated in the reading order; duplicate dropped.')
            clean = False
        else:
            seen.add(ref)
            cleaned.append(ref)
    return cleaned, clean


_DIRECTION_MAP = {
    # ALTO BASEDIRECTION values
    'ltr': 'L', 'rtl': 'R', 'ttb': 'L', 'btt': 'R',
    # PageXML readingDirection values
    'left-to-right': 'L', 'right-to-left': 'R',
    'top-to-bottom': 'L', 'bottom-to-top': 'R',
}


def base_direction(value: Optional[str]) -> Optional[str]:
    """Maps an ALTO/PageXML direction attribute to a BiDi base direction."""
    return _DIRECTION_MAP.get(value)
