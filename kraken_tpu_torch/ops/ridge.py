"""
kraken_tpu_torch.ops.ridge
~~~~~~~~~~~~~~~~~~~~~~~~~~

The multi-scale Sato ridge filter and its threshold on the baseline
channels of the segmentation heatmaps: the port of the JAX package's
``ops/ridge.py:_sato_core_batch`` and of the ``> ridge_threshold`` after
it in ``inference/segmentation.py`` (XLA programs there).

Per sigma in (1, 3, 5, 7, 9) the separable Gaussian-derivative Hessian
(zero padding, correlation, scaled by sigma²), per pixel the low
eigenvalue ``low = ½(hyy + hxx - sqrt((hyy - hxx)² + 4 hxy²))`` and the
response ``max over sigmas of max(0, -low)``; the mask is ``response >
threshold``. The kernel bank is built in float64 and rounded to float32
exactly as the JAX package builds it (:func:`sato_kernel_bank`).

On a CUDA tensor :func:`sato_ridge_threshold` launches the hand-written
kernel of ``csrc/ridge.cu`` (one launch for every chosen channel of every
page) or raises; on a CPU tensor it runs :func:`sato_ridge_reference`, the
plain PyTorch version (the JAX package's two convolutions). The kernel
reads its taps from constant memory, which :func:`upload_bank` fills once
per device and process (the bank is the same for every model).

:func:`plan` mirrors in plain Python the launch the kernel takes (tile,
threads, shared memory, grid) and :func:`macs_per_pixel` the multiply-adds
a pixel it does; :func:`geometry` asks the kernel source itself.
:func:`bound_slots_per_pixel` counts the least instructions a pixel the
filter needs, for its bound.
"""
import ctypes
import functools
import threading
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ['sato_ridge_threshold', 'sato_ridge_reference', 'sato_kernel_bank',
           'upload_bank', 'plan', 'geometry', 'macs_per_pixel', 'bound_slots_per_pixel',
           'SIGMAS']

SIGMAS = (1, 3, 5, 7, 9)
MAX_CHANNELS = 32
# the kernel's launch (csrc/ridge.cu): a block of THREADS threads takes an
# output tile of TILE_W x TILE_H pixels, staged with a halo of the largest
# radius, int(4 * 9 + 0.5)
TILE_W, TILE_H = 128, 16
THREADS = 256
MAX_RADIUS = 36

_BANK_LOCK = threading.Lock()
_BANK_ON: set[int] = set()


def _gauss_deriv_kernel(sigma: float, order: int) -> np.ndarray:
    """1D gaussian (derivative) kernel matching scipy.ndimage conventions."""
    radius = int(4 * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / sigma) ** 2)
    phi /= phi.sum()
    if order == 0:
        return phi.astype(np.float32)
    if order == 1:
        return (-x / sigma ** 2 * phi).astype(np.float32)
    if order == 2:
        return ((x ** 2 / sigma ** 4 - 1 / sigma ** 2) * phi).astype(np.float32)
    raise ValueError(order)


def _sato_kernel_bank(sigmas: tuple):
    """
    Row/column kernel banks for every (sigma, Hessian component) pair,
    zero-padded to a common radius: per sigma the separable pairs
    (row, col) = (g0, g2) for hxx, (g2, g0) for hyy, (g1, g1) for hxy.
    """
    radius = max(int(4 * s + 0.5) for s in sigmas)
    width = 2 * radius + 1

    def padded(sigma, order):
        k = _gauss_deriv_kernel(sigma, order)
        pad = (width - len(k)) // 2
        return np.pad(k, (pad, pad))

    rows, cols = [], []
    for sigma in sigmas:
        for r_ord, c_ord in ((0, 2), (2, 0), (1, 1)):
            rows.append(padded(sigma, r_ord))
            cols.append(padded(sigma, c_ord))
    return (np.stack(rows).astype(np.float32),
            np.stack(cols).astype(np.float32), radius)


def sato_kernel_bank(sigmas: tuple = SIGMAS) -> np.ndarray:
    """The kernel's constant bank: per sigma the non-zero taps of g0, g1
    and g2 (2·int(4σ+0.5)+1 each), float32, 615 values for the default
    sigmas."""
    return np.concatenate([_gauss_deriv_kernel(s, order)
                           for s in sigmas for order in (0, 1, 2)]).astype(np.float32)


def sato_ridge_reference(maps: torch.Tensor, sigmas: tuple = SIGMAS) -> torch.Tensor:
    """
    Plain PyTorch version of the ridge response of an (M, H, W) stack: a
    row pass producing all 3·len(sigmas) Hessian intermediates as channels
    and a grouped column pass, then the eigenvalue epilogue (the JAX
    package's formulation). Returns the float32 (M, H, W) response.
    """
    rows, cols, radius = _sato_kernel_bank(sigmas)
    k = rows.shape[0]
    img = maps.to(torch.float32)[:, None]
    rows_t = torch.from_numpy(rows).to(img.device)[:, None, :, None]
    cols_t = torch.from_numpy(cols).to(img.device)[:, None, None, :]
    x = F.conv2d(img, rows_t, padding=(radius, 0))
    x = F.conv2d(x, cols_t, padding=(0, radius), groups=k)
    response = torch.zeros_like(img[:, 0])
    for i, sigma in enumerate(sigmas):
        s2 = float(sigma ** 2)
        hxx = x[:, 3 * i] * s2
        hyy = x[:, 3 * i + 1] * s2
        hxy = x[:, 3 * i + 2] * s2
        tmp = torch.sqrt((hyy - hxx) ** 2 + 4 * hxy ** 2)
        low = 0.5 * (hyy + hxx - tmp)
        response = torch.maximum(response, torch.where(low < 0, -low, 0.0))
    return response


def plan(N: int, nc: int, H: int, W: int) -> tuple[int, int, int, int, tuple[int, int]]:
    """
    The launch the kernel takes for `nc` channels of `N` (H, W) maps, as
    ``csrc/ridge.cu`` computes it: (tile width, tile height, threads a
    block, dynamic shared memory bytes a block, grid). The grid is
    (tiles_x * tiles_y, N * nc); block (t, p) takes the tile at row
    ``(t // tiles_x) * TILE_H`` and column ``(t % tiles_x) * TILE_W`` of plane p.
    """
    in_w, in_h = TILE_W + 2 * MAX_RADIUS, TILE_H + 2 * MAX_RADIUS
    # the staged tile and the three intermediates (row stride in_w + 1)
    smem = 4 * (in_w * in_h + 3 * TILE_H * (in_w + 1))
    tiles = -(-W // TILE_W) * -(-H // TILE_H)
    return TILE_W, TILE_H, THREADS, smem, (tiles, N * nc)


def geometry(N: int, nc: int, H: int, W: int) -> tuple[int, int, int, int, tuple[int, int]]:
    """:func:`plan` as the kernel source answers it (``ridge_geometry``).
    Builds the kernel library; needs no card."""
    from kraken_tpu_torch.ops.build import load_library
    fn = load_library('ridge').ridge_geometry
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 6
    fn.restype = ctypes.c_int
    out = [ctypes.c_int() for _ in range(6)]
    err = fn(N, nc, H, W, *map(ctypes.byref, out))
    if err != 0:
        raise ValueError(f'ridge_geometry refused N={N} nc={nc} H={H} W={W}')
    tw, th, threads, smem, gx, gy = (v.value for v in out)
    return tw, th, threads, smem, (gx, gy)


def macs_per_pixel(tile_w: int = TILE_W, sigmas: tuple = SIGMAS) -> float:
    """
    Multiply-adds a pixel the kernel issues with `tile_w`-wide tiles: per
    sigma of radius r, 3 components of 2r + 1 taps in a vertical pass that
    filters tile_w + 2r columns for tile_w outputs, then in a horizontal
    pass. 1,482.1875 at 128 (this kernel), 2,238.75 at 32 (the 32 x 32
    tiles of the design it replaced).
    """
    total = 0.0
    for sigma in sigmas:
        r = int(4 * sigma + 0.5)
        total += 3 * (2 * r + 1) * ((tile_w + 2 * r) / tile_w + 1)
    return total


def bound_slots_per_pixel(sigmas: tuple = SIGMAS) -> int:
    """
    The least fp32 instructions a pixel the filter needs, each an FFMA or
    an FADD (one issue slot each, at the same rate), counted on the kernel
    bank: g0 and g2 are even and g1 is odd, and their zero taps (g1's
    centre, g2's at ±sigma) cost nothing. In the vertical pass the 3
    components share one input, so a tap pair (t, -t) costs its sum and
    difference (for the even and the odd components) and one FFMA a
    non-zero component, 5 where all 3 are non-zero instead of 6 taken one
    by one. The horizontal pass filters 3 different intermediates, where a
    pair saves nothing: one instruction a non-zero tap. 1,105 for the
    default sigmas (505 + 600), against 1,230 multiply-adds tap by tap.
    """
    bank = sato_kernel_bank(sigmas)
    slots, start = 0, 0
    for sigma in sigmas:
        r = int(4 * sigma + 0.5)
        nonzero = bank[start:start + 3 * (2 * r + 1)].reshape(3, 2 * r + 1) != 0
        start += nonzero.size
        slots += int(nonzero[:, r].sum()) + int(nonzero.sum())
        for t in range(r + 1, 2 * r + 1):
            k = int(nonzero[:, t].sum())
            adds = int(nonzero[0, t] or nonzero[2, t]) + int(nonzero[1, t])
            slots += min(adds + k, 2 * k)
    return slots


def upload_bank(device: torch.device) -> None:
    """Copies the kernel bank of the default sigmas into the constant
    memory of a CUDA device, unless this process did so already (builds
    the kernel library)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    with _BANK_LOCK:
        if index in _BANK_ON:
            return
        from kraken_tpu_torch.ops.build import load_library
        bank = np.ascontiguousarray(sato_kernel_bank(), np.float32)
        fn = load_library('ridge').ridge_set_bank
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_int
        err = fn(bank.ctypes.data, len(bank), index)
        if err != 0:
            raise RuntimeError(f'ridge_set_bank failed: cudaError {err}')
        _BANK_ON.add(index)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The kernel's C entry point, with its argument types (built at first use)."""
    from kraken_tpu_torch.ops.build import load_library
    fn = load_library('ridge').sato_ridge_forward
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int),
                                                             ctypes.c_int, ctypes.c_float] \
        + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sato_ridge_threshold(probs: torch.Tensor, channels: Sequence[int], threshold: float,
                         response: Optional[torch.Tensor] = None) -> torch.Tensor:
    """
    Thresholded Sato ridge maps of the chosen channels of a heatmap stack.

    Args:
        probs: (N, K, H, W) float32 heatmaps.
        channels: the channels to filter (at most 32).
        threshold: the mask is ``response > threshold``.
        response: optional float32 (N, len(channels), H, W) buffer that
            receives the response itself.

    Returns:
        (N, len(channels), H, W) uint8 mask.

    On a CPU tensor this is the plain version. On a CUDA tensor it launches
    the kernel of ``csrc/ridge.cu`` on the current stream (after
    :func:`upload_bank`, which does nothing once the device has the bank)
    and adds one to
    ``sato_ridge_threshold.launches``; it raises on a type, shape, layout
    or device the kernel does not take and when the launch is refused.
    """
    channels = [int(c) for c in channels]
    if probs.dim() != 4:
        raise ValueError(f'probs must be (N, K, H, W), got {tuple(probs.shape)}')
    N, K, H, W = probs.shape
    if not channels or len(channels) > MAX_CHANNELS or not all(0 <= c < K for c in channels):
        raise ValueError(f'channels {channels} must be 1 to {MAX_CHANNELS} indices below {K}')
    out_shape = (N, len(channels), H, W)
    if response is not None and (tuple(response.shape) != out_shape
                                 or response.dtype != torch.float32
                                 or response.device != probs.device
                                 or not response.is_contiguous()):
        raise ValueError(f'response must be a contiguous float32 {out_shape} tensor '
                         f'on {probs.device}')
    if probs.device.type == 'cpu':
        resp = sato_ridge_reference(probs[:, channels].reshape(-1, H, W)).reshape(out_shape)
        if response is not None:
            response.copy_(resp)
        return (resp > threshold).to(torch.uint8)
    if probs.device.type != 'cuda':
        raise ValueError(f'sato_ridge_threshold runs on cpu or cuda tensors, not {probs.device}')
    if probs.dtype != torch.float32:
        raise TypeError(f'probs must be float32, not {probs.dtype}')
    if not probs.is_contiguous():
        raise ValueError('probs must be contiguous')
    mask = torch.empty(out_shape, dtype=torch.uint8, device=probs.device)
    if mask.numel() == 0:
        return mask
    upload_bank(probs.device)
    fn = _kernel()
    chans = (ctypes.c_int * len(channels))(*channels)
    err = fn(probs.data_ptr(), N, K, H, W, chans, len(channels), float(threshold),
             mask.data_ptr(), response.data_ptr() if response is not None else None,
             probs.device.index, torch.cuda.current_stream(probs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'sato_ridge_threshold kernel launch failed: cudaError {err}')
    sato_ridge_threshold.launches += 1
    return mask


sato_ridge_threshold.launches = 0
