"""
kraken_tpu_torch.ops.segmask
~~~~~~~~~~~~~~~~~~~~~~~~~~~~

The device side of segmentation's reduced heatmap downloads
(``SegmentationInferenceConfig.heatmap_precision``), the port of the JAX
package's XLA programs in ``inference/segmentation.py``:

- :func:`maxpool20`, ``_maxpool20`` (``:61``): the 20×20 max filter of the
  separator maps, scipy's ``mode='reflect'`` (numpy's 'symmetric' padding)
  with the origin-0 anchor;
- :func:`pack_masks`, the thresholds of ``:173-184`` and ``_packbits_w``
  (``:71``): the region, separator-orientation and ridge masks of
  ``'packbits'``, eight pixels a byte, most significant bit first;
- :func:`quantize_u8`, the ``'uint8'`` heatmaps of ``:196``:
  ``round(probs * 255)`` to bytes, half to even.

On a CUDA tensor each wrapper launches its hand-written kernel of
``csrc/segmask.cu`` or raises; on a CPU tensor it runs its plain PyTorch
version (:func:`maxpool20_reference`, :func:`pack_masks_reference`,
:func:`quantize_u8_reference`), which the kernel equals bit for bit.

:func:`probe_link_mbps` is the ``'auto'`` policy's upload probe.
"""
import ctypes
import functools
import threading
import time
from typing import Sequence

import numpy as np
import torch

from kraken_tpu_torch.ops.build import raw_stream

__all__ = ['maxpool20', 'maxpool20_reference', 'pack_masks', 'pack_masks_reference',
           'quantize_u8', 'quantize_u8_reference', 'packbits_reference', 'reflect_index',
           'probe_link_mbps', 'WINDOW', 'BEFORE']

WINDOW = 20
# scipy's origin-0 anchor for an even size: 10 pixels before (9 after)
BEFORE = 10

_COUNT_LOCK = threading.Lock()


def _count(fn) -> None:
    """Adds one to a wrapper's launch counter (the segmenter runs on the
    pipeline's prefetch threads)."""
    with _COUNT_LOCK:
        fn.launches += 1


def reflect_index(n_out: int, n: int, before: int, device=None) -> torch.Tensor:
    """Source indices of ``np.pad(mode='symmetric')`` of an axis of length
    `n` padded by `before` in front and ``n_out - n - before`` behind:
    periodic over ``2 n``, the second half mirrored (what numpy does where
    the pad is wider than the axis)."""
    i = torch.remainder(torch.arange(n_out, device=device) - before, 2 * n)
    return torch.where(i < n, i, 2 * n - 1 - i)


def maxpool20_reference(x: torch.Tensor) -> torch.Tensor:
    """
    Plain PyTorch version of :func:`maxpool20`.

    Args:
        x: (M, H, W) float32 maps.

    Returns:
        (M, H, W) float32: the max over rows y-10..y+9 and columns
        x-10..x+9 of the symmetric-padded maps.
    """
    _, H, W = x.shape
    rows = reflect_index(H + WINDOW - 1, H, BEFORE, x.device)
    cols = reflect_index(W + WINDOW - 1, W, BEFORE, x.device)
    xp = x[:, rows][:, :, cols]
    return xp.unfold(1, WINDOW, 1).amax(-1).unfold(2, WINDOW, 1).amax(-1)


def packbits_reference(m: torch.Tensor) -> torch.Tensor:
    """``_packbits_w``: a boolean (..., W) tensor packed along W, 8 pixels a
    byte, most significant bit first, pad bits 0 (``np.unpackbits(axis=-1)``
    reverses it)."""
    w = m.shape[-1]
    w8 = -(-w // 8)
    m = torch.nn.functional.pad(m.to(torch.uint8), (0, w8 * 8 - w))
    m = m.reshape(*m.shape[:-1], w8, 8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=m.device)
    return (m * weights).sum(-1, dtype=torch.uint8)


def pack_masks_reference(probs: torch.Tensor, regions: Sequence[int], filt: torch.Tensor,
                         ridge: torch.Tensor) -> torch.Tensor:
    """
    Plain PyTorch version of :func:`pack_masks`.

    Args:
        probs: (N, C, H, W) float32 heatmaps.
        regions: the region channels, in the order of their planes.
        filt: (N, 2, H, W) float32, the max-filtered start and end separator
              maps.
        ridge: (N, nb, H, W) uint8 ridge masks (nonzero = set).

    Returns:
        (N, len(regions) + 2 + nb, H, ceil(W / 8)) uint8: the planes
        ``probs[:, c] > 0.5`` for each region channel, ``diff > 0.2``,
        ``diff < -0.2`` (``diff = filt[:, 0] - filt[:, 1]``), the ridge
        masks, packed by :func:`packbits_reference`. The comparisons are in
        float32 against float32 constants, as XLA rounds the JAX package's
        weakly typed ones.
    """
    half = torch.tensor(0.5, dtype=torch.float32)
    fifth = torch.tensor(0.2, dtype=torch.float32)
    masks = [probs[:, c] > half for c in regions]
    diff = filt[:, 0] - filt[:, 1]
    masks += [diff > fifth, diff < -fifth]
    masks += [ridge[:, j] != 0 for j in range(ridge.shape[1])]
    return packbits_reference(torch.stack(masks, 1))


def quantize_u8_reference(probs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`quantize_u8`: ``round(probs * 255)``
    (half to even) as uint8, the product rounded to float32 first; values
    outside [0, 255] saturate, as XLA converts them."""
    q = torch.round(probs * torch.tensor(255.0, dtype=torch.float32))
    return q.clamp(0.0, 255.0).to(torch.uint8)


@functools.lru_cache(maxsize=None)
def _kernels():
    """The kernels' C entry points, with their argument types (built at
    first use)."""
    from kraken_tpu_torch.ops.build import load_library
    lib = load_library('segmask')
    pool = lib.maxpool20_forward
    pool.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    pool.restype = ctypes.c_int
    pack = lib.pack_masks_forward
    pack.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    pack.restype = ctypes.c_int
    quant = lib.quantize_u8_forward
    quant.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_void_p]
    quant.restype = ctypes.c_int
    return pool, pack, quant


def _check_cuda(name: str, tensors: dict, device: torch.device) -> None:
    for key, (t, dtype) in tensors.items():
        if t.device != device:
            raise ValueError(f'{name}: {key} is on {t.device}, not {device}')
        if t.dtype != dtype:
            raise TypeError(f'{name}: {key} must be {dtype}, not {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: {key} must be contiguous')


def _device(name: str, t: torch.Tensor) -> torch.device:
    if t.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'{name} runs on cpu or cuda tensors, not {t.device}')
    return t.device


def maxpool20(x: torch.Tensor) -> torch.Tensor:
    """
    The 20×20 max filter of an (M, H, W) float32 stack (arguments and
    result of :func:`maxpool20_reference`).

    On a CPU tensor this is the plain version. On a CUDA tensor it launches
    the kernel of ``csrc/segmask.cu`` on the current stream and adds one to
    ``maxpool20.launches``; it raises on a type, shape, layout or device
    the kernel does not take and when the launch is refused.
    """
    if x.dim() != 3 or min(x.shape) < 1:
        raise ValueError(f'maxpool20: x must be a non-empty (M, H, W) stack, not {tuple(x.shape)}')
    device = _device('maxpool20', x)
    if device.type == 'cpu':
        return maxpool20_reference(x)
    _check_cuda('maxpool20', {'x': (x, torch.float32)}, device)
    M, H, W = x.shape
    y = torch.empty_like(x)
    err = _kernels()[0](x.data_ptr(), y.data_ptr(), M, H, W, device.index,
                        raw_stream(device.index))
    if err != 0:
        raise RuntimeError(f'maxpool20 kernel launch failed: cudaError {err}')
    _count(maxpool20)
    return y


maxpool20.launches = 0


@functools.lru_cache(maxsize=None)
def _region_table(regions: tuple, device: torch.device) -> torch.Tensor:
    """The region channels as an int32 tensor on `device`, where the packing
    kernel reads them: made once a (channels, device) pair and kept, so a
    page's call uploads nothing (the copy from the host returns when it is
    done, so a kernel on any stream may read it)."""
    return torch.tensor(regions, dtype=torch.int32, device=device)


def pack_masks(probs: torch.Tensor, regions: Sequence[int], filt: torch.Tensor,
               ridge: torch.Tensor) -> torch.Tensor:
    """
    The packed decision masks of ``heatmap_precision='packbits'``
    (arguments and result of :func:`pack_masks_reference`).

    On CPU tensors this is the plain version. On CUDA tensors it launches
    the kernel of ``csrc/segmask.cu`` on the current stream and adds one to
    ``pack_masks.launches``; it raises on a type, shape, layout or device
    the kernel does not take and when the launch is refused. Any number of
    region channels, each in ``0..C-1``.
    """
    regions = tuple(int(c) for c in regions)
    if probs.dim() != 4 or filt.dim() != 4 or ridge.dim() != 4:
        raise ValueError('pack_masks: probs, filt and ridge must be 4-d')
    N, C, H, W = probs.shape
    if filt.shape != (N, 2, H, W) or ridge.shape[0] != N or ridge.shape[2:] != (H, W) \
            or min(N, H, W) < 1:
        raise ValueError(f'pack_masks: probs {tuple(probs.shape)}, filt {tuple(filt.shape)} and '
                         f'ridge {tuple(ridge.shape)} do not fit (N, C, H, W), (N, 2, H, W), '
                         f'(N, nb, H, W)')
    bad = [c for c in regions if not 0 <= c < C]
    if bad:
        raise ValueError(f'pack_masks: region channels {bad} do not lie in 0..{C - 1}')
    device = _device('pack_masks', probs)
    if device.type == 'cpu':
        if filt.device != device or ridge.device != device:
            raise ValueError('pack_masks: probs, filt and ridge must be on one device')
        return pack_masks_reference(probs, regions, filt, ridge)
    _check_cuda('pack_masks', {'probs': (probs, torch.float32), 'filt': (filt, torch.float32),
                               'ridge': (ridge, torch.uint8)}, device)
    nb = ridge.shape[1]
    out = torch.empty((N, len(regions) + 2 + nb, H, -(-W // 8)), dtype=torch.uint8,
                      device=device)
    chans = _region_table(regions, device).data_ptr() if regions else None
    err = _kernels()[1](probs.data_ptr(), chans, len(regions), C, filt.data_ptr(),
                        ridge.data_ptr(), nb, out.data_ptr(), N, H, W, device.index,
                        raw_stream(device.index))
    if err != 0:
        raise RuntimeError(f'pack_masks kernel launch failed: cudaError {err}')
    _count(pack_masks)
    return out


pack_masks.launches = 0


def quantize_u8(probs: torch.Tensor) -> torch.Tensor:
    """
    The ``'uint8'`` heatmaps: ``round(probs * 255)`` as uint8, of any shape
    (arguments and result of :func:`quantize_u8_reference`).

    On a CPU tensor this is the plain version. On a CUDA tensor it launches
    the kernel of ``csrc/segmask.cu`` on the current stream and adds one to
    ``quantize_u8.launches``; it raises on a type, layout or device the
    kernel does not take and when the launch is refused.
    """
    device = _device('quantize_u8', probs)
    if device.type == 'cpu':
        return quantize_u8_reference(probs)
    _check_cuda('quantize_u8', {'probs': (probs, torch.float32)}, device)
    out = torch.empty(probs.shape, dtype=torch.uint8, device=device)
    if out.numel() == 0:
        return out
    if probs.data_ptr() % 16:
        raise ValueError('quantize_u8: probs must be 16-byte aligned')
    err = _kernels()[2](probs.data_ptr(), out.data_ptr(), probs.numel(), device.index,
                        raw_stream(device.index))
    if err != 0:
        raise RuntimeError(f'quantize_u8 kernel launch failed: cudaError {err}')
    _count(quantize_u8)
    return out


quantize_u8.launches = 0


def probe_link_mbps(device) -> float:
    """
    The host-to-device rate in Mbit/s, best of 2 uploads of 4 MB of bytes
    (each followed by a sum on the device and, on a card, a synchronize),
    after one warm-up: ``heatmap_precision='auto'`` picks ``'packbits'``
    below 500 Mbit/s and ``'uint8'`` above (the JAX package's
    ``_probe_link_mbps``).
    """
    device = torch.device(device)
    x = torch.from_numpy(np.zeros((4, 1024, 1024), np.uint8))

    def once():
        x.to(device).sum(dtype=torch.int32)
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    once()
    best = float('inf')
    for _ in range(2):
        t0 = time.perf_counter()
        once()
        best = min(best, time.perf_counter() - t0)
    return 4 * 8 / best
