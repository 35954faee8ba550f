"""
kraken_tpu_torch.binarization
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Adaptive ("non-linear") page binarization in the nlbin algorithm family
(Thomas Breuel / ocropus; behavioral reference: kraken/binarization.py:44).
The page background is estimated with a coarse two-pass sliding-window
percentile on a downscaled copy, the page is flattened against it, and the
black/white points are read off percentiles of the flattened intensities
restricted to high-variance (inky) regions.

This is an independent implementation: the sliding percentile is computed
with stride-trick window stacks instead of scipy's rank filter, resampling
goes through OpenCV (area-average down, bilinear up), and the
variance-masking stage runs on the cv2-backed separable kernels in
:mod:`kraken_tpu_torch.lib.fastfilters`. For the batched device formulation used
on the card see :func:`kraken_tpu_torch.ops.binarize.nlbin_device`. A copy of
the JAX package's ``binarization.py``: both write the same bytes.
"""
import logging
from typing import TYPE_CHECKING

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from kraken_tpu_torch.exceptions import KrakenInputException
from kraken_tpu_torch.lib import fastfilters as ff
from kraken_tpu_torch.lib.util import array2pil, get_im_str, is_bitonal, pil2array

if TYPE_CHECKING:
    from PIL import Image

__all__ = ['nlbin']

logger = logging.getLogger(__name__)


def _resample(page: np.ndarray, out_hw: tuple) -> np.ndarray:
    """Resamples to `out_hw` — area-average shrinking, bilinear growing."""
    try:
        import cv2
        interp = cv2.INTER_AREA if out_hw[0] < page.shape[0] else cv2.INTER_LINEAR
        return cv2.resize(page.astype(np.float32), (out_hw[1], out_hw[0]),
                          interpolation=interp).astype(np.float64)
    except ImportError:  # pragma: no cover
        from scipy.ndimage import zoom
        return zoom(page, (out_hw[0] / page.shape[0], out_hw[1] / page.shape[1]),
                    order=1)


def _sliding_percentile(arr: np.ndarray, q: float, window: tuple) -> np.ndarray:
    """
    Same-size 2-D sliding-window percentile with symmetric edge padding,
    evaluated per pixel in the native library (bit-identical to the numpy
    form below — selection + np.percentile's lerp — and ~5x faster on the
    small nlbin windows), or in row blocks of numpy window stacks as the
    fallback.
    """
    from kraken_tpu_torch import native
    out = native.sliding_percentile_native(arr, q, window)
    if out is not None:
        return out
    wh, ww = window
    top, left = (wh - 1) // 2, (ww - 1) // 2
    padded = np.pad(arr, ((top, wh - 1 - top), (left, ww - 1 - left)),
                    mode='symmetric')
    out = np.empty_like(arr, dtype=np.float64)
    block = max(1, int(2**22 / (arr.shape[1] * wh * ww)))  # ~32 MB of windows
    for r0 in range(0, arr.shape[0], block):
        r1 = min(r0 + block, arr.shape[0])
        view = sliding_window_view(padded[r0:r1 + wh - 1], window)
        view = view[:, :arr.shape[1]]
        out[r0:r1] = np.percentile(view, q, axis=(-2, -1))
    return out


def _estimate_background(page: np.ndarray, zoom: float, perc: int,
                         win: int) -> np.ndarray:
    """
    Coarse page-background model: thin horizontal and vertical percentile
    windows over a `zoom`-downscaled copy, resampled back to full size.
    """
    small_hw = (max(1, int(page.shape[0] * zoom)), max(1, int(page.shape[1] * zoom)))
    small = _resample(page, small_hw)
    small = _sliding_percentile(small, perc, (win, 2))
    small = _sliding_percentile(small, perc, (2, win))
    return _resample(small, page.shape)


def _ink_percentiles(flat: np.ndarray, border: float, escale: float,
                     low: int, high: int) -> tuple:
    """
    Black/white point estimation: restrict the flattened page to its
    high-local-variance (text-bearing) pixels — found via a
    difference-of-gaussian energy map, thresholded and grown with box
    dilations — and take the `low`/`high` percentiles there.
    """
    h, w = flat.shape
    mh, mw = int(border * h), int(border * w)
    inner = flat[mh:h - mh, mw:w - mw]
    sigma = 20.0 * escale
    residual = inner - ff.gaussian_filter(inner, sigma)
    # the FFT gaussian path can ring a few ULPs below zero on the squared
    # residual; clamp before the sqrt or the percentile sees NaNs
    energy = np.sqrt(np.maximum(ff.gaussian_filter(residual * residual, sigma), 0.0))
    texty = energy > 0.3 * energy.max()
    grow = int(50 * escale)
    texty = ff.maximum_filter(texty, (grow, 1))
    texty = ff.maximum_filter(texty, (1, grow))
    samples = inner[texty]
    return np.percentile(samples, low), np.percentile(samples, high)


def nlbin(im: 'Image.Image',
          threshold: float = 0.5,
          zoom: float = 0.5,
          escale: float = 1.0,
          border: float = 0.1,
          perc: int = 80,
          range: int = 20,
          low: int = 5,
          high: int = 90) -> 'Image.Image':
    """
    Performs binarization using non-linear processing.

    Args:
        im: Input image
        threshold: final binarization threshold
        zoom: zoom for background page estimation
        escale: scale for estimating a mask over the text region
        border: ignore this much of the border
        perc: percentage for percentile filters
        range: range (size) for percentile filters
        low: percentile for black estimation
        high: percentile for white estimation

    Returns:
        PIL.Image.Image containing the binarized image

    Raises:
        KrakenInputException: when trying to binarize an empty image.
    """
    im_str = get_im_str(im)
    logger.info(f'Binarizing {im_str}')
    if is_bitonal(im):
        logger.info(f'Binarization skipped: {im_str} is bitonal.')
        return im
    gray = pil2array(im.convert('L'))
    gray = gray / float(np.iinfo(gray.dtype).max)
    span = gray.max() - gray.min()
    if span == 0:
        logger.warning(f'Refusing to binarize empty input image {im_str}')
        raise KrakenInputException('Image is empty')
    page = (gray - gray.min()) / span

    bg = _estimate_background(page, zoom, perc, range)
    flat = np.clip(page - bg + 1.0, 0.0, 1.0)
    lo, hi = _ink_percentiles(flat, border, escale, low, high)
    logger.debug(f'Black/white points {lo:.4f}/{hi:.4f}, thresholding at {threshold}')
    bitonal = (flat - lo) / (hi - lo) > threshold
    return array2pil(np.where(bitonal, 255, 0).astype('B'))
