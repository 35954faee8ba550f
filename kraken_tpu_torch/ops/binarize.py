"""
kraken_tpu_torch.ops.binarize
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

nlbin adaptive binarization on the card: the port of the JAX package's
``ops/binarize.py`` (``nlbin_device``, ``nlbin_batch`` and the jitted
``_nlbin_core`` there). The whole algorithm of
:func:`kraken_tpu_torch.binarization.nlbin` runs on the device the caller
names: min-max normalisation, a background estimate on a copy zoomed by
``zoom`` (antialiased bilinear resize, two sliding-window percentiles, the
resize back), the flattened page, reflect-padded separable Gaussians for
the local variance of its interior, two rectangular dilations, the masked
low and high percentiles by a sort with +inf lanes, and the threshold; only
the bitonal map comes back.

The sliding-window percentile is :func:`window_percentile`: on a CUDA
tensor it launches the hand-written kernel of ``csrc/percentile.cu`` (twice
a page) or raises; on a CPU tensor it runs
:func:`window_percentile_reference`, the plain PyTorch version. Everything
else is torch ops, the Gaussians inside ``_precise_fp32`` (no TF32).

The kernel replaces ``_window_percentile`` (every shifted copy stacked and
sorted across). Its bound is bytes, one read and one write a pixel. Its
first design counted ranks, n^2 comparisons a pixel for a window of n
values, 160 times its bound on a page; nlbin's windows, ``(range, 2)`` and
``(2, range)``, now take the "sliding" route: a warp keeps each of its 32
lines of the window sorted in shared memory and slides it one value an
output, and takes the two ranks from the union of two neighbouring runs by
a merge-path search, about r + log r operations a pixel. Windows with both
sides over 2, and those whose runs exceed a block's shared memory (a range
over ``SLIDE_MAX_RANGE``), keep the rank count ("staged" in shared
memory, or "direct" from device memory). Any map, however much narrower
than the window's pad, takes the route its window takes: every route reads
it through numpy's reflect index. :func:`plan` mirrors the launch in plain
Python; :func:`geometry` asks the source.
"""
import ctypes
import functools
from typing import Union

import numpy as np
import torch
import torch.nn.functional as F

from kraken_tpu_torch.ops.build import raw_stream

__all__ = ['nlbin_device', 'nlbin_batch', 'window_percentile', 'window_percentile_reference',
           'plan', 'geometry', 'ROUTES']

# the kernel's routes (csrc/percentile.cu, by their codes there) and its
# launch: the rank count's output tile of a block (staged, direct); the
# sliding route's warp, SLIDE_STEPS outputs along 33 - s lines of a window
# with a side s of 1 or 2, up to SLIDE_WARPS warps a block, each with its
# strip (SLIDE_STEPS + r rows of STRIDE words) and 32 runs of r values in
# shared memory, of which an H100 block may have SMEM_OPTIN bytes
ROUTES = ('direct', 'staged', 'sliding')
TILE = (32, 8)
SLIDE_STEPS = 32
SLIDE_WARPS = 4
STRIDE = 33
SMEM_OPTIN = 232448


def slide_warp_bytes(r: int) -> int:
    """Shared memory of one sliding warp for lines of r values."""
    return ((SLIDE_STEPS + r) * STRIDE + 32 * r) * 4


# the longest line a sliding warp takes on an H100: (877, 2) slides,
# (878, 2) counts ranks
SLIDE_MAX_RANGE = (SMEM_OPTIN // 4 - SLIDE_STEPS * STRIDE) // (STRIDE + 32)


def _reflect(idx: torch.Tensor, n: int) -> torch.Tensor:
    """numpy's 'reflect' index into [0, n) for any index (a pad wider than
    the array reflects again; an array of one element repeats it)."""
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    m = torch.remainder(idx, period)
    return torch.where(m < n, m, period - m)


def _pad_reflect(x: torch.Tensor, dim: int, before: int, after: int) -> torch.Tensor:
    """``x`` padded along `dim` as ``jnp.pad(mode='reflect')`` pads it."""
    n = x.shape[dim]
    idx = torch.arange(-before, n + after, device=x.device)
    return x.index_select(dim, _reflect(idx, n))


def _ranks(perc: float, n: int) -> tuple[int, int, float, float]:
    """The ranks and weights of ``jnp.percentile(..., method='linear')``
    over n values, in its fp32 arithmetic: q = perc / 100 * (n - 1), the
    floor(q)-th and ceil(q)-th smallest values, weighted 1 - (q - floor q)
    and q - floor q."""
    q = np.float32(perc) / np.float32(100)
    q = np.float32(q * np.float32(n - 1))
    low, high = np.floor(q), np.ceil(q)
    w_hi = np.float32(q - low)
    w_lo = np.float32(np.float32(1) - w_hi)
    clip = lambda v: int(min(max(v, 0), n - 1))  # noqa: E731
    return clip(low), clip(high), float(w_lo), float(w_hi)


def _pads(size: tuple[int, int]) -> tuple[tuple[int, int], tuple[int, int]]:
    sh, sw = size
    return ((sh - 1) // 2, sh - 1 - (sh - 1) // 2), ((sw - 1) // 2, sw - 1 - (sw - 1) // 2)


def window_percentile_reference(x: torch.Tensor, perc: float,
                                size: tuple[int, int]) -> torch.Tensor:
    """
    Plain PyTorch version of :func:`window_percentile`: the JAX
    ``_window_percentile`` written out (every shifted copy of the
    reflect-padded maps stacked, sorted across, the two ranks gathered and
    weighted in fp32), so it equals the kernel bit for bit.
    """
    N, H, W = x.shape
    sh, sw = size
    (top, bottom), (left, right) = _pads(size)
    padded = _pad_reflect(_pad_reflect(x, 1, top, bottom), 2, left, right)
    windows = torch.stack([padded[:, dy:dy + H, dx:dx + W]
                           for dy in range(sh) for dx in range(sw)])
    lo, hi, w_lo, w_hi = _ranks(perc, sh * sw)
    ordered = torch.sort(windows, dim=0).values
    return ordered[lo] * w_lo + ordered[hi] * w_hi


def plan(N: int, H: int, W: int, size: tuple[int, int]
         ) -> tuple[str, tuple[int, int], int, int, int]:
    """
    The launch the kernel takes for N (H, W) maps and a window of ``size =
    (sh, sw)`` on an H100, as ``csrc/percentile.cu`` computes it: (route,
    output tile (x, y), tiles a block, dynamic shared memory bytes a block,
    blocks). The route is the first that takes the window:

    - "sliding", a window with a side s of 1 or 2 whose warp fits a block:
      "vertical" when sw <= 2 (runs of sh down the columns; a warp's tile
      33 - s columns by SLIDE_STEPS rows), else "horizontal" (runs of sw
      along the rows; SLIDE_STEPS columns by 33 - s rows); block b takes
      the warp tiles ``b * tiles`` to ``+ tiles``, tile u of map
      ``u // (strips * groups)``, strip ``u // groups % strips`` along the
      runs and group ``u % groups`` across them;
    - "staged", a 32 x 8 tile and its reflect halo in shared memory;
    - "direct", the same tile read from device memory.
    """
    sh, sw = size
    if sh <= 2 or sw <= 2:
        vertical = sw <= 2
        r, s = (sh, sw) if vertical else (sw, sh)
        warps = min(SLIDE_WARPS, SMEM_OPTIN // slide_warp_bytes(r))
        if warps:
            tile = (33 - s, SLIDE_STEPS) if vertical else (SLIDE_STEPS, 33 - s)
            units = N * -(-W // tile[0]) * -(-H // tile[1])
            return 'sliding', tile, warps, warps * slide_warp_bytes(r), -(-units // warps)
    blocks = N * -(-W // TILE[0]) * -(-H // TILE[1])
    staged = (TILE[1] + sh - 1) * (TILE[0] + sw - 1) * 4
    if staged <= SMEM_OPTIN:
        return 'staged', TILE, 1, staged, blocks
    return 'direct', TILE, 1, 0, blocks


def geometry(N: int, H: int, W: int, size: tuple[int, int], device_index: int = 0
             ) -> tuple[str, tuple[int, int], int, int, int]:
    """:func:`plan` as the kernel source answers it on a card
    (``percentile_geometry``, which reads the card's shared memory a
    block)."""
    from kraken_tpu_torch.ops.build import load_library
    fn = load_library('percentile').percentile_geometry
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] * 5 \
        + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = [ctypes.c_int() for _ in range(5)] + [ctypes.c_longlong()]
    err = fn(N, H, W, size[0], size[1], device_index, *map(ctypes.byref, out))
    if err != 0:
        raise ValueError(f'percentile_geometry refused {(N, H, W)} {size} (cudaError {err})')
    route, tw, th, tiles, smem, blocks = (v.value for v in out)
    return ROUTES[route], (tw, th), tiles, smem, blocks


@functools.lru_cache(maxsize=None)
def _kernel():
    """The kernel's C entry point, with its argument types (built at first use)."""
    from kraken_tpu_torch.ops.build import load_library
    fn = load_library('percentile').percentile_forward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2 \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def window_percentile(x: torch.Tensor, perc: float, size: tuple[int, int]) -> torch.Tensor:
    """
    Same-size sliding-window percentile of each of N maps, as the JAX
    ``_window_percentile`` computes it on one: the `perc` percentile
    (``jnp.percentile``'s 'linear' method) of the ``size = (sh, sw)``
    window at every pixel of the maps padded with numpy's 'reflect' by
    ``(sh - 1) // 2`` rows above and ``(sw - 1) // 2`` columns to the left,
    the rest below and to the right.

    Args:
        x: (N, H, W) float32 maps.
        perc: the percentile, in [0, 100].
        size: the window (sh, sw), both positive.

    On a CPU tensor this is the plain version. On a CUDA tensor it launches
    the kernel of ``csrc/percentile.cu`` on the current stream, on the
    route :func:`plan` gives, adds one to ``window_percentile.launches``
    and to the route's count in ``window_percentile.route_launches``, and
    waits for the kernel's error word. It raises on a type, shape, layout
    or window the kernel does not take (contiguous tensors), on a NaN in
    the maps (a window with a NaN has no percentile rank; the kernel
    reports it) and when the launch is refused.
    """
    if x.dim() != 3:
        raise ValueError(f'window_percentile takes (N, H, W) maps, not {tuple(x.shape)}')
    if x.dtype != torch.float32:
        raise TypeError(f'window_percentile takes float32 maps, not {x.dtype}')
    sh, sw = (int(v) for v in size)
    if sh < 1 or sw < 1:
        raise ValueError(f'window_percentile takes a window of positive sides, not {size}')
    if not 0 <= perc <= 100:
        raise ValueError(f'percentile {perc} outside [0, 100]')
    N, H, W = x.shape
    device = x.device
    if device.type == 'cpu':
        if torch.isnan(x).any():
            raise ValueError('window_percentile refuses maps with NaN')
        return window_percentile_reference(x, perc, (sh, sw))
    if device.type != 'cuda':
        raise ValueError(f'window_percentile runs on cpu or cuda tensors, not {device}')
    if not x.is_contiguous():
        raise ValueError('window_percentile takes contiguous maps')
    if x.numel() == 0:
        return torch.empty_like(x)
    return _launch(x, perc, (sh, sw), plan(N, H, W, (sh, sw))[0])


def _launch(x: torch.Tensor, perc: float, size: tuple[int, int], route: str) -> torch.Tensor:
    """One launch of the kernel on `route` for maps :func:`window_percentile`
    has checked (non-empty, contiguous, on the card), counted, with its
    error word read; the source refuses a route that does not take the
    window."""
    N, H, W = x.shape
    sh, sw = size
    out = torch.empty_like(x)
    lo, hi, w_lo, w_hi = _ranks(perc, sh * sw)
    error = torch.zeros(1, dtype=torch.int32, device=x.device)
    err = _kernel()(x.data_ptr(), out.data_ptr(), error.data_ptr(), N, H, W, sh, sw, lo, hi,
                    w_lo, w_hi, ROUTES.index(route), x.device.index, raw_stream(x.device.index))
    if err != 0:
        raise RuntimeError(f'percentile kernel launch failed on the {route} route: cudaError {err}')
    window_percentile.launches += 1
    window_percentile.route_launches[route] += 1
    if int(error.item()):
        raise ValueError('window_percentile refuses maps with NaN')
    return out


window_percentile.launches = 0
window_percentile.route_launches = dict.fromkeys(ROUTES, 0)


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _gaussian_filter(im: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (N, H, W) maps with reflect padding, as
    the JAX ``_gaussian_filter`` (a correlation with a radius of
    ``int(4 sigma + 0.5)``, along H then W)."""
    from kraken_tpu_torch.inference.recognition import _precise_fp32
    radius = int(4 * sigma + 0.5)
    if radius < 1:
        return im
    k = torch.from_numpy(_gaussian_kernel1d(sigma, radius)).to(im.device)
    with _precise_fp32(torch.float32):
        x = _pad_reflect(im, 1, radius, radius)
        x = F.conv2d(x[:, None], k.view(1, 1, -1, 1))[:, 0]
        x = _pad_reflect(x, 2, radius, radius)
        return F.conv2d(x[:, None], k.view(1, 1, 1, -1))[:, 0]


def _binary_dilation_rect(mask: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Rectangular dilation of (N, H, W) bool masks: a max over the window
    with XLA's 'SAME' padding ((k - 1) // 2 before, the rest after)."""
    (top, bottom), (left, right) = _pads(size)
    x = F.pad(mask.to(torch.float32)[:, None], (left, right, top, bottom))
    return F.max_pool2d(x, tuple(size), stride=1)[:, 0] > 0


def _masked_percentile(values: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """The `q` percentile of each map's values where its mask is set, as the
    JAX ``_masked_percentile`` (a sort with the other lanes at +inf, the
    fp32 rank ``(count - 1) * (q / 100)``, a linear interpolation); (N,)."""
    N = values.shape[0]
    keep = mask.reshape(N, -1)
    flat = torch.where(keep, values.reshape(N, -1), torch.tensor(float('inf'),
                                                                 device=values.device))
    ordered = torch.sort(flat, dim=1).values
    count = keep.sum(dim=1, dtype=torch.int32)
    rank = (count - 1).to(torch.float32) * torch.tensor(q / 100.0, dtype=torch.float32,
                                                       device=values.device)
    size = flat.shape[1]
    lo = torch.clamp(torch.floor(rank).to(torch.int32), 0, size - 1)
    hi = torch.clamp(lo + 1, 0, size - 1)
    frac = rank - lo.to(torch.float32)
    v_lo = ordered.gather(1, lo.to(torch.int64)[:, None])[:, 0]
    v_hi = torch.where(hi < count, ordered.gather(1, hi.to(torch.int64)[:, None])[:, 0], v_lo)
    return v_lo + frac * (v_hi - v_lo)


def _resize(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """(N, H, W) maps resized as ``jax.image.resize(..., 'bilinear')``:
    half-pixel centres, antialiased where it shrinks."""
    shrink = size[0] < x.shape[1] or size[1] < x.shape[2]
    return F.interpolate(x[:, None], size=size, mode='bilinear', align_corners=False,
                         antialias=shrink)[:, 0]


def _nlbin_flat(image: torch.Tensor, zoom: float = 0.5, escale: float = 1.0,
                border: float = 0.1, perc: int = 80, range_: int = 20, low: float = 5,
                high: float = 90) -> torch.Tensor:
    """The flattened (N, H, W) float32 pages in [0, 1] that nlbin
    thresholds, on their device."""
    N, h, w = image.shape
    image = image - image.amin(dim=(1, 2), keepdim=True)
    image = image / torch.clamp(image.amax(dim=(1, 2), keepdim=True), min=1e-9)
    # background estimation on a zoomed copy
    zh, zw = max(1, int(h * zoom)), max(1, int(w * zoom))
    m = _resize(image, (zh, zw)).contiguous()
    m = window_percentile(m, perc, (range_, 2))
    m = window_percentile(m, perc, (2, range_))
    m = _resize(m, (h, w))
    flat = torch.clamp(image - m + 1, 0, 1)

    # thresholds from the high-variance (text) regions of the interior
    o0, o1 = int(border * h), int(border * w)
    est = flat[:, o0:h - o0, o1:w - o1]
    v = est - _gaussian_filter(est, escale * 20.0)
    v = torch.sqrt(_gaussian_filter(v ** 2, escale * 20.0))
    v = v > 0.3 * v.amax(dim=(1, 2), keepdim=True)
    v = _binary_dilation_rect(v, (int(escale * 50), 1))
    v = _binary_dilation_rect(v, (1, int(escale * 50)))
    lo = _masked_percentile(est, v, low)[:, None, None]
    hi = _masked_percentile(est, v, high)[:, None, None]
    return torch.clamp((flat - lo) / (hi - lo), 0, 1)


def _nlbin_core(image: torch.Tensor, threshold: float = 0.5, **kwargs) -> torch.Tensor:
    """nlbin over (N, H, W) float32 pages on their device: (N, H, W) bool,
    True where the page is paper. `kwargs` are :func:`_nlbin_flat`'s."""
    return _nlbin_flat(image, **kwargs) > threshold


def _pages(ims, device) -> torch.Tensor:
    if isinstance(ims, torch.Tensor):
        return ims.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(ims, dtype=np.float32), device=device)


def nlbin_device(im: Union[np.ndarray, torch.Tensor], threshold: float = 0.5,
                 zoom: float = 0.5, escale: float = 1.0, border: float = 0.1, perc: int = 80,
                 range: int = 20, low: int = 5, high: int = 90,
                 device: Union[str, torch.device] = 'cuda') -> torch.Tensor:
    """
    nlbin of one (H, W) grayscale page (uint8 or float; values above 1.5
    are taken as 0-255 and divided by 255) on `device`, which defaults to
    the card. Returns an (H, W) bool tensor on that device, True where the
    page is paper (white, as the host nlbin's 255).
    """
    from kraken_tpu_torch.inference.recognition import resolve_device
    arr = _pages(im, resolve_device(device))
    if arr.max() > 1.5:
        arr = arr / 255.0
    return _nlbin_core(arr[None], threshold=threshold, zoom=zoom, escale=escale, border=border,
                       perc=perc, range_=range, low=low, high=high)[0]


def nlbin_batch(ims: Union[np.ndarray, torch.Tensor],
                device: Union[str, torch.device] = 'cuda', **kwargs) -> torch.Tensor:
    """nlbin over an (N, H, W) batch of float pages in [0, 1] on `device`
    (each page normalised on its own, as the JAX ``vmap`` does); (N, H, W)
    bool tensor on that device. `kwargs` are :func:`_nlbin_core`'s
    (``range_`` for the window)."""
    from kraken_tpu_torch.inference.recognition import resolve_device
    return _nlbin_core(_pages(ims, resolve_device(device)), **kwargs)
