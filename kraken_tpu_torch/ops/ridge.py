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
"""
import ctypes
import functools
import threading
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ['sato_ridge_threshold', 'sato_ridge_reference', 'sato_kernel_bank',
           'upload_bank', 'SIGMAS']

SIGMAS = (1, 3, 5, 7, 9)
MAX_CHANNELS = 32

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
