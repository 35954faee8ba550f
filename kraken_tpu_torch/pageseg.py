"""
kraken_tpu_torch.pageseg
~~~~~~~~~~~~~~~~~~~~~~~~

Legacy bbox page segmentation for bi-level images (ocropy lineage;
reference: kraken/pageseg.py): connected-component scale estimation, column
separator detection (whitespace or black rules), gradient-map line seeds,
label propagation, and heuristic reading order. Emits BBoxLine records.

Provenance: the filter sequences and constants implement the ocropy
algorithm (Copyright Thomas M. Breuel, Apache-2.0, via kraken/pageseg.py)
and are pinned for output parity — see the NOTICE file at the repo root.
A copy of the JAX package's ``pageseg.py``; the port's copy is held to it
in tests/test_torch_pageseg.py.
"""
import logging
import uuid
from typing import Callable, Optional, Union

import numpy as np
import PIL
from kraken_tpu_torch.lib.fastfilters import (gaussian_filter, maximum_filter,
                                        uniform_filter)

from kraken_tpu_torch.containers import BBoxLine, Segmentation
from kraken_tpu_torch.exceptions import KrakenInputException
from kraken_tpu_torch.lib import morphology as morph
from kraken_tpu_torch.lib.geometry import reading_order
from kraken_tpu_torch.lib.util import get_im_str, is_bitonal, pil2array

logger = logging.getLogger(__name__)

__all__ = ['segment']


def _objects(binary: np.ndarray):
    labels, _ = morph.label(binary)
    return morph.find_objects(labels)


def _slice_areas(objs) -> np.ndarray:
    """Bounding-box pixel areas of find_objects slices in one array (the
    per-slice np.prod of morph.slice_area dominated estimate_scale)."""
    return np.array([(o[0].stop - o[0].start) * (o[1].stop - o[1].start)
                     for o in objs], dtype=np.int64)


def estimate_scale(binary: np.ndarray) -> float:
    """
    Estimates the typical grapheme scale from the median sqrt-area of
    midsized connected components: smallest-first, each unclaimed bbox
    contributes its sqrt-area once per pixel; the median runs over that
    pixel multiset. Claimed regions are disjoint (a bbox is only accepted
    when untouched), so the multiset is an area-weighted value list — the
    weighted median below is exactly np.median over the materialized map.
    """
    objs = _objects(binary)
    areas = _slice_areas(objs)
    claimed = np.zeros(binary.shape, bool)
    vals = []
    wts = []
    for i in np.argsort(areas, kind='stable'):
        obj = objs[i]
        if claimed[obj].any():
            continue
        claimed[obj] = True
        v = areas[i] ** 0.5
        if 3 < v < 100:
            vals.append(v)
            wts.append(int(areas[i]))
    if not vals:
        return float(np.median(np.zeros(0)))  # nan, like the empty selection
    vals = np.asarray(vals)
    wts = np.asarray(wts)
    order = np.argsort(vals)
    vals = vals[order]
    cum = np.cumsum(wts[order])
    total = int(cum[-1])
    if total % 2:
        return float(vals[np.searchsorted(cum, (total - 1) // 2 + 1)])
    lo = vals[np.searchsorted(cum, total // 2)]
    hi = vals[np.searchsorted(cum, total // 2 + 1)]
    return float((lo + hi) / 2)


def compute_boxmap(binary: np.ndarray, scale: float,
                   threshold: tuple[float, int] = (.5, 4),
                   dtype: str = 'i') -> np.ndarray:
    """Marks grapheme-cluster-sized connected components."""
    boxmap = np.zeros(binary.shape, dtype)
    objs = _objects(binary)
    # membership only sets constant 1s, so the size order is irrelevant
    area_sqrt = np.sqrt(_slice_areas(objs))
    for i in np.flatnonzero((threshold[0] * scale <= area_sqrt)
                            & (area_sqrt <= threshold[1] * scale)):
        boxmap[objs[i]] = 1
    return boxmap


def remove_hlines(binary: np.ndarray, scale: float, maxsize: int = 10) -> np.ndarray:
    """Removes long horizontal rules."""
    labels, _ = morph.label(binary)
    for i, obj in enumerate(morph.find_objects(labels)):
        if morph.slice_width(obj) > maxsize * scale:
            labels[obj][labels[obj] == i + 1] = 0
    return np.array(labels != 0, 'B')


def compute_separators_morph(binary: np.ndarray, scale: float,
                             sepwiden: int = 10, maxcolseps: int = 2) -> np.ndarray:
    """Finds vertical black rules acting as column separators."""
    d0 = int(max(5, scale / 4))
    d1 = int(max(5, scale)) + sepwiden
    thick = morph.dilate_rect(binary, (d0, d1))
    vert = morph.binary_open_rect(thick, (10 * scale, 1))
    vert = morph.erode_rect(vert, (d0 // 2, sepwiden))
    vert = morph.select_regions(vert, morph.slice_width, min=3, nbest=2 * maxcolseps)
    vert = morph.select_regions(vert, morph.slice_height, min=20 * scale, nbest=maxcolseps)
    return vert


def compute_colseps_conv(binary: np.ndarray, scale: float = 1.0,
                         minheight: int = 10, maxcolseps: int = 2) -> np.ndarray:
    """Finds whitespace column separators by smoothing and thresholding."""
    # the order-0 and order-(0,1) filters share sigmas, so in the FFT
    # regime (kernels beyond the ~100-tap crossover, where axis passes
    # already run sequentially) they share the whole axis-0 pass —
    # bit-identical there. Below the crossover the fused cv2 kernel order
    # differs in the last ulp, so the original two-filter form is kept.
    from kraken_tpu_torch.lib.fastfilters import _FFT_TAPS, _gauss_kernel1d
    if len(_gauss_kernel1d(scale, 0)) > _FFT_TAPS:
        vpass = gaussian_filter(1.0 * binary, (scale, 0))
        smoothed = gaussian_filter(vpass, (0, scale * 0.5))
        grad = gaussian_filter(vpass, (0, scale * 0.5), order=(0, 1))
    else:
        smoothed = gaussian_filter(1.0 * binary, (scale, scale * 0.5))
        grad = gaussian_filter(1.0 * binary, (scale, scale * 0.5), order=(0, 1))
    smoothed = uniform_filter(smoothed, (5.0 * scale, 1))
    thresh = (smoothed < np.amax(smoothed) * 0.1)
    grad = uniform_filter(grad, (10.0 * scale, 1))
    grad = (grad > 0.5 * np.amax(grad))
    seps = np.minimum(thresh, maximum_filter(grad, (int(scale), int(5 * scale))))
    seps = maximum_filter(seps, (int(2 * scale), 1))
    return morph.select_regions(seps, morph.slice_height, min=minheight * scale,
                                nbest=maxcolseps)


def compute_black_colseps(binary: np.ndarray, scale: float, maxcolseps: int):
    """Column separators from black rules; removes the rules from the image."""
    seps = compute_separators_morph(binary, scale, maxcolseps=maxcolseps)
    colseps = np.maximum(compute_colseps_conv(binary, scale, maxcolseps=maxcolseps), seps)
    binary = np.minimum(binary, 1 - seps)
    return colseps, binary


def compute_white_colseps(binary: np.ndarray, scale: float, maxcolseps: int) -> np.ndarray:
    """Column separators from whitespace only."""
    return compute_colseps_conv(binary, scale, maxcolseps=maxcolseps)


def _norm_max(v: np.ndarray) -> np.ndarray:
    return v / np.amax(v)


def compute_gradmaps(binary: np.ndarray, scale: float, gauss: bool = False):
    """Vertical-gradient top/bottom edge maps over grapheme components."""
    boxmap = compute_boxmap(binary, scale)
    cleaned = boxmap * binary
    if gauss:
        grad = gaussian_filter(1.0 * cleaned, (0.3 * scale, 6 * scale), order=(1, 0))
    else:
        grad = gaussian_filter(1.0 * cleaned, (max(4, 0.3 * scale), scale), order=(1, 0))
        grad = uniform_filter(grad, (1, 6 * scale))
    bottom = _norm_max((grad < 0) * (-grad))
    top = _norm_max((grad > 0) * grad)
    return bottom, top, boxmap


def compute_line_seeds(binary: np.ndarray, bottom: np.ndarray, top: np.ndarray,
                       colseps: np.ndarray, scale: float,
                       threshold: float = 0.2) -> np.ndarray:
    """Marks the bands between matched baseline/topline candidates."""
    vrange = int(scale)
    bmarked = maximum_filter(bottom == maximum_filter(bottom, (vrange, 0)), (2, 2))
    bmarked = bmarked * (bottom > threshold * np.amax(bottom) * threshold) * (1 - colseps)
    tmarked = maximum_filter(top == maximum_filter(top, (vrange, 0)), (2, 2))
    tmarked = tmarked * (top > threshold * np.amax(top) * threshold / 2) * (1 - colseps)
    tmarked = maximum_filter(tmarked, (1, 20))
    delta = max(3, int(scale / 2))
    from kraken_tpu_torch import native
    seeds = native.line_seeds_native(bmarked, tmarked, delta, 5 * scale)
    if seeds is None:
        seeds = np.zeros(binary.shape, 'i')
        for x in range(bmarked.shape[1]):
            transitions = sorted([(y, 1) for y in np.nonzero(bmarked[:, x])[0]] +
                                 [(y, 0) for y in np.nonzero(tmarked[:, x])[0]])[::-1]
            transitions.append((0, 0))
            for ls in range(len(transitions) - 1):
                y0, s0 = transitions[ls]
                if s0 == 0:
                    continue
                seeds[y0 - delta:y0, x] = 1
                y1, s1 = transitions[ls + 1]
                if s1 == 0 and (y0 - y1) < 5 * scale:
                    seeds[y1:y0, x] = 1
    seeds = maximum_filter(seeds, (1, int(1 + scale)))
    seeds = seeds * (1 - colseps)
    seeds, _ = morph.label(seeds)
    return seeds


def _compute_lines(segmentation: np.ndarray, scale: float) -> list:
    """Filters labeled line segments by size, returning slice bounds."""
    bounds = []
    for i, obj in enumerate(morph.find_objects(segmentation)):
        if obj is None:
            continue
        if morph.slice_width(obj) < 2 * scale or morph.slice_height(obj) < scale:
            continue
        if not (segmentation[obj] == i + 1).any():
            continue
        bounds.append(obj)
    return bounds


def rotate_lines(lines: np.ndarray, angle: float, offset: int) -> np.ndarray:
    """Rotates line bounding boxes back into the original frame."""
    angle = np.radians(angle)
    r = np.array([[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]])
    p = np.array(lines).reshape((-1, 2))
    offset = np.array([2 * offset])
    p = p.dot(r).reshape((-1, 4)).astype(int) + offset
    x = np.sort(p[:, [0, 2]])
    y = np.sort(p[:, [1, 3]])
    return np.column_stack((x.flatten(), y.flatten())).reshape(-1, 4)


def segment(im: PIL.Image.Image,
            text_direction: str = 'horizontal-lr',
            scale: Optional[float] = None,
            maxcolseps: float = 2,
            black_colseps: bool = False,
            no_hlines: bool = True,
            pad: Union[int, tuple[int, int]] = 0,
            mask: Optional[np.ndarray] = None,
            reading_order_fn: Callable = reading_order) -> Segmentation:
    """
    Segments a bi-level page into text lines, returning bbox lines in
    reading order.

    Args:
        im: bi-level input page (mode '1' or 'L').
        text_direction: principal text direction (also rotates the input for
                        vertical scripts).
        scale: grapheme scale; auto-estimated when None.
        maxcolseps: maximum number of whitespace column separators.
        black_colseps: treat vertical black rules as column separators.
        no_hlines: remove small horizontal rules first.
        pad: extra left/right padding on line boxes.
        mask: bi-level mask of regions to ignore (disables column detection).
        reading_order_fn: line ordering function.

    Raises:
        KrakenInputException: on non-bitonal input or bad text direction.
    """
    im_str = get_im_str(im)
    logger.info(f'Segmenting {im_str}')
    if im.mode != '1' and not is_bitonal(im):
        raise KrakenInputException(f'Image {im_str} is not bi-level')
    imagename = getattr(im, 'filename', None)

    if text_direction.startswith('horizontal'):
        angle = 0
        offset = (0, 0)
    elif text_direction == 'vertical-lr':
        angle = 270
        offset = (0, im.size[1])
    elif text_direction == 'vertical-rl':
        angle = 90
        offset = (im.size[0], 0)
    else:
        raise KrakenInputException(f'Invalid text direction {text_direction}')

    im = im.rotate(angle, expand=True)
    arr = pil2array(im)
    binary = np.array(arr > 0.5 * (np.amin(arr) + np.amax(arr)), 'i')
    binary = 1 - binary

    def _empty():
        return Segmentation(text_direction=text_direction, imagename=imagename,
                            type='bbox', regions=None, line_orders=None,
                            lines=[], script_detection=False)

    _, ccs = morph.label(1 - binary)
    if ccs > np.dot(*im.size) / (30 * 30):
        logger.warning(f'Connected component count implausible for a page: {ccs}')
        return _empty()

    if not scale:
        scale = estimate_scale(binary)
    if no_hlines:
        binary = remove_hlines(binary, scale)

    try:
        if mask is not None:
            if mask.mode != '1' and not is_bitonal(mask):
                raise KrakenInputException('Mask is not bitonal')
            mask = mask.convert('1')
            if mask.size != im.size:
                raise KrakenInputException(f'Mask size {mask.size} differs from the '
                                           f'page image size {im.size}')
            logger.info('Segmenter received a mask; column detection turned off.')
            colseps = pil2array(mask.rotate(angle, expand=True))
        elif black_colseps:
            colseps, binary = compute_black_colseps(binary, scale, maxcolseps)
        else:
            colseps = compute_white_colseps(binary, scale, maxcolseps)
    except ValueError:
        logger.warning(f'Column finder raised (empty page image?) for {im_str}')
        return _empty()

    bottom, top, boxmap = compute_gradmaps(binary, scale)
    seeds = compute_line_seeds(binary, bottom, top, colseps, scale)
    llabels = morph.propagate_labels(boxmap, seeds, conflict=0)
    spread = morph.spread_labels(seeds, maxdist=scale)
    llabels = np.where(llabels > 0, llabels, spread * binary)
    segmentation = llabels * binary

    bounds = _compute_lines(segmentation, scale)
    bbox_lines = [BBoxLine(id=f'_{uuid.uuid4()}',
                           bbox=(obj[1].start, obj[0].start, obj[1].stop, obj[0].stop))
                  for obj in bounds]
    order = reading_order_fn(bbox_lines, text_direction[-2:])
    boxes = [bbox_lines[i].bbox for i in order]
    if isinstance(pad, int):
        pad = (pad, pad)
    boxes = [(max(b[0] - pad[0], 0), b[1], min(b[2] + pad[1], im.size[0]), b[3])
             for b in boxes]
    lines = [BBoxLine(id=f'_{uuid.uuid4()}', bbox=tuple(b))
             for b in rotate_lines(boxes, 360 - angle, offset).tolist()]
    return Segmentation(text_direction=text_direction, imagename=imagename,
                        type='bbox', regions=None, line_orders=None,
                        lines=lines, script_detection=False)
