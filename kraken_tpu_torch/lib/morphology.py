"""
kraken_tpu_torch.lib.morphology
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Rectangular morphology and label-propagation primitives used by the legacy
bbox page segmenter (ocropy lineage; reference: kraken/lib/morph.py +
kraken/lib/sl.py). Built directly on scipy.ndimage. A copy of the JAX
package's ``lib/morphology.py``.
"""
import numpy as np
from scipy.ndimage import (distance_transform_edt, find_objects as _find_objects,
                           label as _label, maximum_filter, minimum_filter,
                           uniform_filter)

__all__ = ['label', 'find_objects', 'dilate_rect', 'erode_rect',
           'binary_dilate_rect', 'binary_erode_rect', 'binary_open_rect',
           'spread_labels', 'propagate_labels', 'select_regions',
           'slice_area', 'slice_height', 'slice_width']


def label(image: np.ndarray, **kw):
    """scipy label with integer-dtype coercion fallback. The default-
    structure 2-D case (every call site in pageseg) runs the native C++
    union-find CCL, which reproduces scipy's raster-first-encounter label
    numbering exactly (tests/test_torch_pageseg.py randomized equality)."""
    if not kw and getattr(image, 'ndim', 0) == 2:
        from kraken_tpu_torch import native
        out = native.label4_native(image)
        if out is not None:
            return out
    try:
        return _label(image, **kw)
    except Exception:
        for t in ('int32', 'uint32', 'int64', 'uint64', 'int16', 'uint16'):
            try:
                return _label(np.array(image, dtype=t), **kw)
            except Exception:
                continue
        return _label(image, **kw)


def find_objects(image: np.ndarray, **kw):
    """scipy find_objects with integer-dtype coercion fallback; 2-D
    integer inputs run the native single-pass bbox scan (same output,
    including None entries for absent labels)."""
    if getattr(image, 'ndim', 0) == 2 and set(kw) <= {'max_label'} \
            and np.issubdtype(getattr(image, 'dtype', np.float64), np.integer):
        from kraken_tpu_torch import native
        out = native.find_objects_native(image, kw.get('max_label', 0))
        if out is not None:
            return out
    try:
        return _find_objects(image, **kw)
    except Exception:
        for t in ('int32', 'uint32', 'int64', 'uint64', 'int16', 'uint16'):
            try:
                return _find_objects(np.array(image, dtype=t), **kw)
            except Exception:
                continue
        return _find_objects(image, **kw)


def slice_area(s) -> int:
    """Pixel area of a 2D slice tuple."""
    return int(np.prod([max(x.stop - x.start, 0) for x in s[:2]]))


def slice_height(s) -> int:
    return s[0].stop - s[0].start


def slice_width(s) -> int:
    return s[1].stop - s[1].start


def dilate_rect(image, size, origin=0):
    """Grayscale dilation with a rectangular structuring element."""
    return maximum_filter(image, size, origin=origin)


def erode_rect(image, size, origin=0):
    """Grayscale erosion with a rectangular structuring element."""
    return minimum_filter(image, size, origin=origin)


def binary_dilate_rect(image, size, origin=0):
    """Binary dilation via a box filter."""
    out = np.zeros(image.shape, 'f')
    uniform_filter(image, size, output=out, origin=origin, mode='constant', cval=0)
    return np.array(out > 0, 'i')


def binary_erode_rect(image, size, origin=0):
    """Binary erosion via a box filter."""
    out = np.zeros(image.shape, 'f')
    uniform_filter(image, size, output=out, origin=origin, mode='constant', cval=1)
    return np.array(out == 1, 'i')


def binary_open_rect(image, size, origin=0):
    """Binary opening (erosion then dilation)."""
    return binary_dilate_rect(binary_erode_rect(image, size, origin=origin),
                              size, origin=origin)


def spread_labels(labels: np.ndarray, maxdist=9999999) -> np.ndarray:
    """Assigns every background pixel the label of its nearest labeled pixel
    (up to maxdist)."""
    try:
        import cv2
        # cv2's labelled distance transform runs ~5x faster than scipy's
        # feature transform on full pages; DIST_MASK_PRECISE keeps the
        # euclidean metric exact (ties at equidistant pixels may resolve
        # differently, which the downstream line clustering is insensitive to)
        background = (labels == 0).astype(np.uint8)
        distances, nearest = cv2.distanceTransformWithLabels(
            background, cv2.DIST_L2, cv2.DIST_MASK_PRECISE,
            labelType=cv2.DIST_LABEL_PIXEL)
        lut = np.zeros(int(nearest.max()) + 1, labels.dtype)
        seeds = labels != 0
        lut[nearest[seeds]] = labels[seeds]
        spread = lut[nearest]
    except ImportError:  # pragma: no cover
        distances, features = distance_transform_edt(labels == 0,
                                                     return_distances=True,
                                                     return_indices=True)
        indexes = features[0] * labels.shape[1] + features[1]
        spread = labels.ravel()[indexes.ravel()].reshape(*labels.shape)
    spread *= (distances < maxdist)
    return spread


def propagate_labels(image: np.ndarray, labels: np.ndarray, conflict=0) -> np.ndarray:
    """
    Propagates `labels` onto the connected components of `image`; components
    overlapping multiple labels get the `conflict` value.
    """
    rlabels, _ = label(image)
    # correspondences between component ids and overlapping labels
    combo = rlabels.astype(np.int64) * 100000 + labels.astype(np.int64)
    pairs = np.unique(combo)
    comp = pairs // 100000
    lab = pairs % 100000
    outputs = np.zeros(int(rlabels.max()) + 1, 'i')
    collision = -(1 << 30)
    for o, i in zip(comp, lab):
        if outputs[o] != 0:
            outputs[o] = collision
        else:
            outputs[o] = i
    outputs[outputs == collision] = conflict
    outputs[0] = 0
    return outputs[rlabels]


def select_regions(binary: np.ndarray, score_fn, min=0, nbest=100000) -> np.ndarray:
    """
    Keeps at most `nbest` connected components whose `score_fn(slice)` is
    above `min`.
    """
    labels, _ = label(binary)
    objects = find_objects(labels)
    scores = [score_fn(o) for o in objects]
    best = np.argsort(scores)
    keep = np.zeros(len(objects) + 1, 'i')
    if nbest > 0:
        for i in best[-nbest:]:
            if scores[i] <= min:
                continue
            keep[i + 1] = 1
    return keep[labels]
