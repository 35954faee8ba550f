"""
kraken_tpu_torch.containers
~~~~~~~~~~~~~~~~~~~~~~~~~~~

Container dataclasses for segmentation and recognition results, matching the
reference's public data model (kraken/containers.py): line records
(BaselineLine/BBoxLine), regions, page segmentations, and OCR records with
per-code-point cuts/confidences, BiDi display↔logical reordering, and
polygon-section cut aggregation on slicing.

All classes are JSON-round-trippable: Segmentation re-inflates nested dicts
into the proper line/region classes on construction.
"""
import copy
from abc import ABC, abstractmethod
from dataclasses import asdict, dataclass, fields
from typing import TYPE_CHECKING, Any, Literal, Optional, Union

import numpy as np

from kraken_tpu_torch.lib.bidi import get_display_map
from kraken_tpu_torch.lib.geometry import compute_polygon_section, precompute_polygon_sections

if TYPE_CHECKING:
    from os import PathLike
    from PIL import Image

__all__ = ['ProcessingStep', 'ocr_line', 'BaselineLine', 'BBoxLine', 'Region',
           'Segmentation', 'ocr_record', 'BaselineOCRRecord', 'BBoxOCRRecord']


def _copy_jsonish(v):
    """Independent copy of a JSON-like structure (dicts/lists/tuples of
    scalars) without `copy.deepcopy`'s memo/dispatch machinery."""
    if isinstance(v, dict):
        return {k: _copy_jsonish(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_copy_jsonish(x) for x in v]
    if isinstance(v, tuple):
        return tuple(_copy_jsonish(x) for x in v)
    return v


def _line_asdict(line) -> dict:
    """`dataclasses.asdict` semantics for flat line records — independent
    copies of geometry point lists and tag structures — without the generic
    per-element dataclass recursion."""
    d = {}
    for f in fields(line):
        v = getattr(line, f.name)
        if isinstance(v, list):
            if v and isinstance(v[0], (list, tuple)):
                # geometry: list of points (preserve per-point type)
                d[f.name] = [p.copy() if isinstance(p, list) else tuple(p)
                             for p in v]
            elif any(isinstance(p, (list, tuple, dict)) for p in v):
                d[f.name] = _copy_jsonish(v)
            else:
                d[f.name] = v.copy()
        elif isinstance(v, dict):
            d[f.name] = _copy_jsonish(v)
        elif isinstance(v, tuple):
            d[f.name] = tuple(v)
        else:
            d[f.name] = v
    return d


@dataclass
class ProcessingStep:
    """
    A processing step in the recognition pipeline (recorded in serializer
    output).

    Attributes:
        id: unique identifier
        category: kind of processing performed
        description: natural-language description
        settings: parameters of the step
    """
    id: str
    category: Literal['preprocessing', 'processing', 'postprocessing']
    description: str
    settings: dict[str, Union[dict, str, float, int, bool]]


@dataclass
class ocr_line(ABC):
    """
    Shared fields of all line records.

    Attributes:
        id: unique identifier
        text: transcription
        base_dir: BiDi base (paragraph) direction override ('L'/'R')
        imagename: path of the associated image
        tags: dict mapping tag types to values
        split: train/validation/test assignment
        regions: identifiers of containing regions
        language: language identifiers
    """
    id: str
    text: Optional[str] = None
    base_dir: Optional[Literal['L', 'R']] = None
    imagename: Optional[Union[str, 'PathLike']] = None
    tags: Optional[dict[str, list[dict[str, str]]]] = None
    split: Optional[Literal['train', 'validation', 'test']] = None
    regions: Optional[list[str]] = None
    language: Optional[list[str]] = None


@dataclass
class BaselineLine(ocr_line):
    """
    A line in baseline + bounding polygon format.

    Attributes:
        baseline: polyline [(x0, y0), ...]
        boundary: closed bounding polygon of the line
    """
    type: str = 'baselines'
    baseline: Optional[list[tuple[int, int]]] = None
    boundary: Optional[list[tuple[int, int]]] = None

    def to_bbox(self, text_direction: Literal['horizontal-lr', 'horizontal-rl',
                                              'vertical-lr', 'vertical-rl'] = 'horizontal-lr') -> 'BBoxLine':
        """
        Casts to an axis-aligned BBoxLine using the extent of the boundary
        (or baseline when no boundary is set).
        """
        pts = self.boundary if self.boundary else self.baseline
        xs = [p[0] for p in pts]
        ys = [p[1] for p in pts]
        return BBoxLine(id=self.id,
                        text=self.text,
                        base_dir=self.base_dir,
                        imagename=self.imagename,
                        tags=self.tags,
                        split=self.split,
                        regions=self.regions,
                        language=self.language,
                        bbox=(min(xs), min(ys), max(xs), max(ys)),
                        text_direction=text_direction)


@dataclass
class BBoxLine(ocr_line):
    """
    A line in axis-aligned bounding-box format.

    Attributes:
        bbox: (xmin, ymin, xmax, ymax)
        text_direction: principal line orientation + document reading
                        direction
    """
    type: str = 'bbox'
    bbox: Optional[tuple[int, int, int, int]] = None
    text_direction: Literal['horizontal-lr', 'horizontal-rl',
                            'vertical-lr', 'vertical-rl'] = 'horizontal-lr'

    def to_baseline(self, topline: Optional[bool] = False) -> 'BaselineLine':
        """
        Casts to a BaselineLine: the boundary is the bbox as a closed
        5-point polygon; the baseline is a 2-point segment along the reading
        axis inset by a quarter of the perpendicular extent (bottom for
        standard baselines, top for hanging/topline, center for None).
        """
        x0, y0, x1, y1 = self.bbox
        w, h = x1 - x0, y1 - y0
        td = self.text_direction
        if td.startswith('horizontal'):
            if topline is None:
                y = y0 + h // 2
            elif topline:
                y = y0 + h // 4
            else:
                y = y0 + (3 * h) // 4
            baseline = [(x0, y), (x1, y)] if td == 'horizontal-lr' else [(x1, y), (x0, y)]
        else:
            if topline is None:
                x = x0 + w // 2
            elif topline:
                x = x0 + (3 * w) // 4 if td == 'vertical-lr' else x0 + w // 4
            else:
                x = x0 + w // 4 if td == 'vertical-lr' else x0 + (3 * w) // 4
            baseline = [(x, y0), (x, y1)]
        boundary = [(x0, y0), (x1, y0), (x1, y1), (x0, y1), (x0, y0)]
        return BaselineLine(id=self.id,
                            text=self.text,
                            base_dir=self.base_dir,
                            imagename=self.imagename,
                            tags=self.tags,
                            split=self.split,
                            regions=self.regions,
                            language=self.language,
                            baseline=baseline,
                            boundary=boundary)


@dataclass
class Region:
    """
    A polygonal page region.

    Attributes:
        id: unique identifier
        boundary: closed bounding polygon
        imagename: path of the associated image
        tags: dict mapping tag types to values
    """
    id: str
    boundary: list[tuple[int, int]]
    imagename: Optional[Union[str, 'PathLike']] = None
    tags: Optional[dict[str, list[dict[str, str]]]] = None
    language: Optional[list[str]] = None


@dataclass
class Segmentation:
    """
    A page segmentation (or recognition) result.

    Attributes:
        type: 'baselines' or 'bbox' depending on the line record kind
        imagename: path of the segmented image
        text_direction: principal orientation and reading direction
        script_detection: True when line records carry tags
        lines: line records in reading order
        regions: dict mapping region types to lists of regions
        line_orders: alternative reading orders (lists of line indices)
    """
    type: Literal['baselines', 'bbox']
    imagename: Union[str, 'PathLike']
    text_direction: Literal['horizontal-lr', 'horizontal-rl', 'vertical-lr', 'vertical-rl']
    script_detection: bool
    lines: Optional[list[Union[BaselineLine, BBoxLine]]] = None
    regions: Optional[dict[str, list[Region]]] = None
    line_orders: Optional[list[list[int]]] = None
    language: Optional[list[str]] = None

    def __post_init__(self):
        if not self.regions:
            self.regions = {}
        if not self.lines:
            self.lines = []
        if not self.line_orders:
            self.line_orders = []
        if not self.language:
            self.language = None
        if self.lines and not isinstance(self.lines[0], (BBoxLine, BaselineLine)):
            line_cls = BBoxLine if self.type == 'bbox' else BaselineLine
            self.lines = [line_cls(**line) for line in self.lines]
        for regs in self.regions.values():
            if regs and not isinstance(regs[0], Region):
                self.regions = {k: [Region(**reg) for reg in v] for k, v in self.regions.items()}
                break

    def to_bbox(self) -> 'Segmentation':
        """Returns an independent bbox-typed copy of this segmentation."""
        if self.type == 'bbox':
            return copy.deepcopy(self)
        return Segmentation(type='bbox',
                            imagename=self.imagename,
                            text_direction=self.text_direction,
                            script_detection=self.script_detection,
                            lines=[ln.to_bbox(text_direction=self.text_direction)
                                   for ln in (self.lines or [])],
                            regions=copy.deepcopy(self.regions),
                            line_orders=copy.deepcopy(self.line_orders),
                            language=copy.deepcopy(self.language))

    def to_baselines(self, topline: Optional[bool] = False) -> 'Segmentation':
        """Returns an independent baseline-typed copy of this segmentation."""
        if self.type == 'baselines':
            return copy.deepcopy(self)
        return Segmentation(type='baselines',
                            imagename=self.imagename,
                            text_direction=self.text_direction,
                            script_detection=self.script_detection,
                            lines=[ln.to_baseline(topline=topline) for ln in (self.lines or [])],
                            regions=copy.deepcopy(self.regions),
                            line_orders=copy.deepcopy(self.line_orders),
                            language=copy.deepcopy(self.language))


class ocr_record(ABC):
    """
    Recognition result for a single line: the predicted string plus
    per-code-point cuts and confidences, in either display or logical order.
    """
    base_dir = None

    def __init__(self,
                 prediction: str,
                 cuts,
                 confidences: list[float],
                 display_order: bool = True,
                 logits=None,
                 image=None) -> None:
        self._prediction = prediction
        self._cuts = cuts
        self._confidences = confidences
        self._display_order = display_order
        self.logits = logits
        self.image = image

    @property
    @abstractmethod
    def type(self):
        ...

    def __len__(self) -> int:
        return len(self._prediction)

    def __str__(self) -> str:
        return self._prediction

    @property
    def prediction(self) -> str:
        return self._prediction

    @property
    def cuts(self) -> list:
        return self._cuts

    @property
    def confidences(self) -> list[float]:
        return self._confidences

    def __iter__(self):
        self.idx = -1
        return self

    @abstractmethod
    def __next__(self):
        ...

    @abstractmethod
    def __getitem__(self, key):
        ...

    @abstractmethod
    def display_order(self, base_dir) -> 'ocr_record':
        ...

    @abstractmethod
    def logical_order(self, base_dir) -> 'ocr_record':
        ...


class BaselineOCRRecord(ocr_record, BaselineLine):
    """
    Recognition result of a single baseline-format line.

    Per-code-point cuts are stored as baseline offsets (start, end) and
    resolved into bounding-polygon sections lazily at construction via
    :func:`kraken_tpu_torch.lib.geometry.precompute_polygon_sections`. Slicing
    aggregates a whole polygon section spanning the slice instead of
    returning per-character polygons.
    """
    type = 'baselines'

    def __init__(self,
                 prediction: str,
                 cuts: list[tuple[int, int]],
                 confidences: list[float],
                 line: Union[BaselineLine, dict[str, Any]],
                 base_dir: Optional[Literal['L', 'R']] = None,
                 display_order: bool = True,
                 logits=None,
                 image=None,
                 _sections=None) -> None:
        if not isinstance(line, dict):
            line = _line_asdict(line)
        if line['type'] != 'baselines':
            raise TypeError('Expected a baseline-type line record')
        BaselineLine.__init__(self, **line)
        self._line_base_dir = self.base_dir
        self.base_dir = base_dir
        ocr_record.__init__(self, prediction, cuts, confidences, display_order, logits, image)
        if _sections is not None:
            # internal reorder fast path: sections already computed for the
            # same baseline/boundary, just permuted by the caller
            (self._polygon_cuts,
             self._intersection_cache,
             self._bl_length) = _sections
        else:
            # per-character polygon cuts are computed lazily on first
            # geometry access (`cuts`, indexing, iteration): the geometry
            # is ~70 ms/page of host time that consumers which only read
            # `prediction`/`confidences` never need. The reference computes
            # them eagerly in the ctor (kraken/containers.py:484-488);
            # observable values are identical (tests/test_container.py).
            self._polygon_cuts = None
            self._intersection_cache, self._bl_length = {}, 0.0

    def _ensure_sections(self) -> None:
        """Materializes the per-character polygon cuts on first access."""
        if self._polygon_cuts is not None:
            return
        if self.baseline and self.boundary and self._cuts:
            (self._polygon_cuts,
             self._intersection_cache,
             self._bl_length) = precompute_polygon_sections(self.baseline, self.boundary, self._cuts)
        else:
            self._polygon_cuts, self._intersection_cache, self._bl_length = [], {}, 0.0

    def __repr__(self) -> str:
        return (f'pred: {self.prediction} baseline: {self.baseline} '
                f'boundary: {self.boundary} confidences: {self.confidences}')

    def __next__(self):
        if self.idx + 1 < len(self):
            self.idx += 1
            self._ensure_sections()
            return (self.prediction[self.idx],
                    self._polygon_cuts[self.idx],
                    self.confidences[self.idx])
        raise StopIteration

    def _get_raw_item(self, key: int):
        if key < 0:
            key += len(self)
        if key >= len(self):
            raise IndexError('Record index %d out of range' % key)
        return (self.prediction[key], self._cuts[key], self.confidences[key])

    def __getitem__(self, key):
        self._ensure_sections()
        if isinstance(key, slice):
            recs = [self._get_raw_item(i) for i in range(*key.indices(len(self)))]
            prediction = ''.join(x[0] for x in recs)
            flat_offsets = sum((tuple(x[1]) for x in recs), ())
            min_d, max_d = min(flat_offsets), max(flat_offsets)
            eps = np.finfo(float).eps
            cd_min = min(self._bl_length - eps, eps if min_d == 0 else min_d)
            cd_max = min(self._bl_length - eps, eps if max_d == 0 else max_d)
            p1 = self._intersection_cache.get(cd_min)
            p2 = self._intersection_cache.get(cd_max)
            if p1 is not None and p2 is not None:
                o = np.int_(p1).reshape(-1, 2).tolist()
                o.extend(np.int_(np.roll(p2, 2)).reshape(-1, 2).tolist())
                cut = tuple(o)
            else:
                cut = compute_polygon_section(self.baseline, self.boundary, min_d, max_d)
            return (prediction, cut, float(np.mean([x[2] for x in recs])))
        if isinstance(key, int):
            if key < 0:
                key += len(self)
            if key >= len(self):
                raise IndexError('Record index %d out of range' % key)
            return (self.prediction[key], self._polygon_cuts[key], self.confidences[key])
        raise TypeError('Invalid argument type')

    @property
    def cuts(self) -> tuple:
        self._ensure_sections()
        return tuple(self._polygon_cuts)

    def logical_order(self, base_dir: Optional[Literal['L', 'R']] = None) -> 'BaselineOCRRecord':
        """Returns the record in Unicode logical (reading) order."""
        return self._reorder(base_dir) if self._display_order else self

    def display_order(self, base_dir: Optional[Literal['L', 'R']] = None) -> 'BaselineOCRRecord':
        """Returns the record in display (left-to-right) order."""
        return self if self._display_order else self._reorder(base_dir)

    def _reorder(self, base_dir: Optional[Literal['L', 'R']] = None) -> 'BaselineOCRRecord':
        prediction, order = get_display_map(self._prediction,
                                            base_dir if base_dir in ('L', 'R') else None)
        line = BaselineLine(id=self.id,
                            baseline=self.baseline,
                            boundary=self.boundary,
                            text=self.text,
                            base_dir=self._line_base_dir,
                            imagename=self.imagename,
                            tags=self.tags,
                            split=self.split,
                            regions=self.regions)
        return BaselineOCRRecord(prediction=prediction,
                                 cuts=[self._cuts[idx] for idx in order],
                                 confidences=[self._confidences[idx] for idx in order],
                                 line=line,
                                 base_dir=base_dir,
                                 display_order=not self._display_order,
                                 logits=self.logits,
                                 image=self.image,
                                 _sections=([self._polygon_cuts[idx] for idx in order],
                                            self._intersection_cache,
                                            self._bl_length)
                                 if self._polygon_cuts is not None
                                 and len(self._polygon_cuts) == len(self._cuts)
                                 else None)


class BBoxOCRRecord(ocr_record, BBoxLine):
    """
    Recognition result of a single bbox-format line; cuts are absolute
    4-point rectangles. Slicing merges the covered rectangles into one.
    """
    type = 'bbox'

    def __init__(self,
                 prediction: str,
                 cuts,
                 confidences: list[float],
                 line: Union[BBoxLine, dict[str, Any]],
                 base_dir: Optional[Literal['L', 'R']] = None,
                 display_order: bool = True,
                 logits=None,
                 image=None) -> None:
        if not isinstance(line, dict):
            line = _line_asdict(line)
        if line['type'] != 'bbox':
            raise TypeError('Expected a bbox-type line record')
        BBoxLine.__init__(self, **line)
        self._line_base_dir = self.base_dir
        self.base_dir = base_dir
        ocr_record.__init__(self, prediction, cuts, confidences, display_order, logits, image)

    def __repr__(self) -> str:
        return f'pred: {self.prediction} bbox: {self.bbox} confidences: {self.confidences}'

    def __next__(self):
        if self.idx + 1 < len(self):
            self.idx += 1
            return (self.prediction[self.idx], self.cuts[self.idx], self.confidences[self.idx])
        raise StopIteration

    def _get_raw_item(self, key: int):
        if key < 0:
            key += len(self)
        if key >= len(self):
            raise IndexError('Record index %d out of range' % key)
        return (self.prediction[key], self.cuts[key], self.confidences[key])

    def __getitem__(self, key):
        if isinstance(key, slice):
            recs = [self._get_raw_item(i) for i in range(*key.indices(len(self)))]
            prediction = ''.join(x[0] for x in recs)
            flat = [coord for pol in (x[1] for x in recs) for point in pol for coord in point]
            min_x, max_x = min(flat[::2]), max(flat[::2])
            min_y, max_y = min(flat[1::2]), max(flat[1::2])
            cut = ((min_x, min_y), (max_x, min_y), (max_x, max_y), (min_x, max_y))
            return (prediction, cut, float(np.mean([x[2] for x in recs])))
        if isinstance(key, int):
            return self._get_raw_item(key)
        raise TypeError('Invalid argument type')

    def logical_order(self, base_dir: Optional[Literal['L', 'R']] = None) -> 'BBoxOCRRecord':
        """Returns the record in Unicode logical (reading) order."""
        return self._reorder(base_dir) if self._display_order else self

    def display_order(self, base_dir: Optional[Literal['L', 'R']] = None) -> 'BBoxOCRRecord':
        """Returns the record in display (left-to-right) order."""
        return self if self._display_order else self._reorder(base_dir)

    def _reorder(self, base_dir: Optional[Literal['L', 'R']] = None) -> 'BBoxOCRRecord':
        prediction, order = get_display_map(self.prediction,
                                            base_dir if base_dir in ('L', 'R') else None)
        line = BBoxLine(id=self.id,
                        bbox=self.bbox,
                        text=self.text,
                        base_dir=self._line_base_dir,
                        imagename=self.imagename,
                        tags=self.tags,
                        split=self.split,
                        regions=self.regions)
        return BBoxOCRRecord(prediction=prediction,
                             cuts=[self.cuts[idx] for idx in order],
                             confidences=[self.confidences[idx] for idx in order],
                             line=line,
                             base_dir=base_dir,
                             display_order=not self._display_order,
                             logits=self.logits,
                             image=self.image)
