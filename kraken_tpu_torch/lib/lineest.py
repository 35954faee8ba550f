"""
kraken_tpu_torch.lib.lineest
~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Centerline estimation and vertical dewarping for bbox line images in the
ocropy CenterNormalizer family (behavioral reference:
kraken/lib/lineest.py), used by the input transforms of 1-channel bbox
models with valid_norm. A copy of the JAX package's ``lib/lineest.py``
that takes its exact numpy paths: the bilinear resample is the numpy
gather (the JAX package's native C++ twin is bit-identical to it), and the
horizontal blur pass is a float64 full-row FFT.

The centerline estimate takes an argmax over the smoothed line, so even
last-ulp kernel differences can flip ties and shift the dewarped image by
a pixel; the arithmetic here therefore repeats the JAX package's step for
step. The smoothing of the integer argmax track runs in integer arithmetic
(scipy preserves the input dtype), and that truncation is part of the
pinned behavior.
"""
import copy
import warnings
from typing import TYPE_CHECKING

import numpy as np
from scipy.ndimage import affine_transform, gaussian_filter1d, uniform_filter

if TYPE_CHECKING:
    from PIL import Image

__all__ = ['CenterNormalizer', 'dewarp']


def _scipy_gauss_kernel(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage's order-0 gaussian kernel (identical weights), in
    correlate1d orientation."""
    r = int(truncate * sigma + 0.5)
    x = np.arange(-r, r + 1)
    k = np.exp(-0.5 / (sigma * sigma) * x ** 2)
    k /= k.sum()
    # gaussian_filter1d hands correlate1d the reversed kernel; symmetric
    # order-0 kernels make this a no-op, kept for fidelity
    return k[::-1]


def _bilinear_diag(img: np.ndarray, inv_scale: float,
                   out_shape: tuple[int, int], cval: float) -> np.ndarray:
    """
    scipy.ndimage.affine_transform with a diagonal matrix, order=1,
    mode='constant', as one vectorized numpy gather: out[i, j] samples
    img at (i*inv_scale, j*inv_scale) with bilinear weights and constant
    fill outside — the same formula scipy evaluates per pixel (its generic
    per-pixel transform loop was ~15x slower at these shapes; equality is
    regression-tested).
    """
    h, w = img.shape
    oh, ow = out_shape
    r = np.arange(oh) * inv_scale
    c = np.arange(ow) * inv_scale
    r0 = np.floor(r).astype(np.int64)
    c0 = np.floor(c).astype(np.int64)
    fr = r - r0
    fc = c - c0
    # pad one constant row/col so r0+1/c0+1 gathers stay in bounds; points
    # sampling beyond the input are overwritten with cval below. The
    # diagonal matrix makes the interpolation separable: lerp rows, then
    # columns (fp-associativity differences vs the per-pixel form are
    # below the float32 output rounding).
    padded = np.full((h + 1, w + 1), float(cval))
    padded[:h, :w] = img
    rr0 = np.clip(r0, 0, h - 1)
    cc0 = np.clip(c0, 0, w - 1)
    rows = padded[rr0] * (1 - fr)[:, None] + padded[rr0 + 1] * fr[:, None]
    out = rows[:, cc0] * (1 - fc)[None, :] + rows[:, cc0 + 1] * fc[None, :]
    # scipy fills any coordinate strictly outside the input extent
    # [0, h-1] x [0, w-1] with pure cval (no edge blending)
    out[(r < 0) | (r > h - 1), :] = cval
    out[:, (c < 0) | (c > w - 1)] = cval
    return out


def scale_to_h(img: np.ndarray, target_height: int, order: int = 1,
               dtype=np.dtype('f'), cval: int = 0) -> np.ndarray:
    """Scales a 2D image to a target height preserving aspect ratio."""
    h, w = img.shape
    scale = target_height * 1.0 / h
    if order == 1:
        resized = _bilinear_diag(img * 1.0, 1.0 / scale,
                                 (target_height, int(scale * w)), cval)
    else:
        with warnings.catch_warnings():
            warnings.simplefilter('ignore', UserWarning)
            resized = affine_transform(img * 1.0,
                                       np.full(2, 1.0 / scale),
                                       order=order,
                                       output_shape=(target_height, int(scale * w)),
                                       mode='constant', cval=cval)
    return resized.astype(dtype)


def _fft_pass(src: np.ndarray, k: np.ndarray) -> np.ndarray:
    """
    Correlates every row of `src` with `k` under zero ('constant') borders
    through a full-length float64 real FFT: the rows are zero-padded by the
    kernel radius and on to scipy's FFT fast length, and the kernel spectrum
    is that of the reversed kernel.
    """
    import scipy.fft as sfft
    r = len(k) // 2
    h, w = src.shape
    nfast = sfft.next_fast_len(w + 2 * r + len(k) - 1, real=True)
    padded = np.zeros((h, nfast), src.dtype)
    padded[:, r:r + w] = src
    freq = sfft.rfft(padded, nfast, axis=1)
    kfreq = sfft.rfft(k[::-1], nfast)
    full = sfft.irfft(freq * kfreq[None, :], nfast, axis=1)
    start = len(k) - 1
    return full[:, start:start + w]


class CenterNormalizer:
    """
    Estimates the text centerline from a gaussian-smoothed column argmax and
    vertically dewarps the line to a fixed height around it.
    """

    def __init__(self, target_height: int = 48, params: tuple = (4, 1.0, 0.3)):
        self.target_height = target_height
        self.range, self.smoothness, self.extra = params

    def setHeight(self, target_height: int) -> None:
        self.target_height = target_height

    def measure(self, line: np.ndarray) -> None:
        """
        Fits the centerline of an ink-intensity array (text bright on dark):
        a heavy blur turns each column into a unimodal intensity profile
        whose argmax tracks the text core; a faint whole-line box blur is
        mixed in so empty columns inherit their neighborhood's maximum
        instead of defaulting to row 0. The track is then smoothed (integer
        arithmetic, see module docstring) and the half-band radius `r` set
        from the mean |row - center| over ink pixels.

        The heavy 2-D blur uses sigmas of half the line height, i.e.
        kernels wider than the line is tall and hundreds of taps along x —
        scipy's direct correlate1d is slow there. The vertical
        pass runs as one banded-weight matmul (the kernel covers every row,
        so it IS a dense h x h operator) and the horizontal pass as a
        float64 full-row FFT (:func:`_fft_pass`). Both deviate from
        scipy's sequential summation only in the last ulp; the argmax track
        they feed rides a smooth unimodal profile whose neighboring values
        differ by orders of magnitude more, and track equality against
        scipy is regression-tested on real pages (tests/test_lineest.py).
        """
        h, w = line.shape
        self.shape = (h, w)
        blurred = self._heavy_blur(line.astype(np.float64, copy=False),
                                   h * 0.5, h * self.smoothness)
        blurred += 1e-3 * uniform_filter(blurred, (h * 0.5, w), mode='constant')
        track = blurred.argmax(axis=0)
        self.center = np.asarray(gaussian_filter1d(track, h * self.extra), 'i')
        ink_rows, ink_cols = np.nonzero(line)
        self.mad = np.abs(ink_rows - self.center[ink_cols]).mean()
        self.r = int(1 + self.range * self.mad)

    @staticmethod
    def _heavy_blur(line: np.ndarray, sigma_y: float, sigma_x: float) -> np.ndarray:
        """gaussian_filter(line, (sigma_y, sigma_x), mode='constant') with
        scipy's own kernels: vertical pass as a banded matmul, horizontal
        pass via :func:`_fft_pass` (see measure's docstring)."""
        h, w = line.shape
        ky = _scipy_gauss_kernel(sigma_y)
        kx = _scipy_gauss_kernel(sigma_x)
        ry = len(ky) // 2
        # W[i, j] = ky[ry + (j - i)]: out[i] = sum_j W[i, j] * in[j] with
        # constant-zero borders (kernel entries outside [0, h) fall away)
        idx = ry + (np.arange(h)[None, :] - np.arange(h)[:, None])
        W = np.where((idx >= 0) & (idx < len(ky)), ky[np.clip(idx, 0, len(ky) - 1)], 0.0)
        out = W @ line
        if len(kx) > 1:
            out = _fft_pass(out, kx)
        return out

    def dewarp(self, img: np.ndarray, cval: int = 0, dtype=np.dtype('f')) -> np.ndarray:
        if img.shape != self.shape:
            raise Exception('dewarp input shape differs from the measured shape')
        h, w = img.shape
        padded = np.vstack([cval * np.ones((h, w)), img, cval * np.ones((h, w))])
        center = self.center + h
        # extract a fixed-height band around the centerline per column
        rows = np.clip(center[None, :] + np.arange(-self.r, self.r)[:, None], 0, padded.shape[0] - 1)
        dewarped = padded[rows, np.arange(w)[None, :]]
        return np.array(dewarped, dtype=dtype)

    def normalize(self, img: np.ndarray, order: int = 1, dtype=np.dtype('f'),
                  cval: int = 0) -> np.ndarray:
        band = self.dewarp(img, cval=cval, dtype=dtype)
        if not band.shape[0]:
            band = img
        return scale_to_h(band, self.target_height, order=order, dtype=dtype,
                          cval=cval)


def dewarp(normalizer: CenterNormalizer, im: 'Image.Image') -> 'Image.Image':
    """Dewarps a PIL line image with a CenterNormalizer. The measurement goes
    into a copy of `normalizer`: the loader's threads share one (the
    transforms'), and a measurement another thread makes between this one's
    measure and dewarp would dewarp this line by that line's centerline."""
    from kraken_tpu_torch.lib.util import array2pil, pil2array

    normalizer = copy.copy(normalizer)
    line = pil2array(im)
    ink = np.amax(line) - line  # dark-on-light → ink intensity
    normalizer.measure(ink * 1.0 / np.amax(ink))
    return array2pil(normalizer.normalize(line, cval=np.amax(line)))
