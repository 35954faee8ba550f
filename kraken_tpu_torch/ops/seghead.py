"""
kraken_tpu_torch.ops.seghead
~~~~~~~~~~~~~~~~~~~~~~~~~~~~

The head of the segmentation forward: bilinear upsampling of the network's
logits to the padded page size, then the sigmoid. The port of
``jax.image.resize(logits.astype(float32), ..., 'bilinear')`` and
``jax.nn.sigmoid`` in the JAX package's
``inference/segmentation.py:prepare_segmentation`` (an XLA program there).

Upsampling only: output pixel o samples the input at
``max((o + 0.5) * in / out - 0.5, 0)``, clamped at the last row/column,
which is what ``jax.image.resize`` computes when the output is at least as
large as the input on both axes (it renormalises the weights of taps that
fall outside). When an axis shrinks ``jax.image.resize`` antialiases, so
the head raises instead.

On a CUDA tensor :func:`seg_head` launches the hand-written kernel of
``csrc/seghead.cu`` or raises; on a CPU tensor it runs
:func:`seg_head_reference`, the plain PyTorch version.
"""
import ctypes
import functools

import torch

from kraken_tpu_torch.ops.build import DTYPE_CODES, raw_stream

__all__ = ['seg_head', 'seg_head_reference']


def _check_upsampling(shape, out_h: int, out_w: int) -> None:
    if len(shape) != 4:
        raise ValueError(f'logits must be (N, K, h, w), got {tuple(shape)}')
    if out_h < shape[2] or out_w < shape[3]:
        raise ValueError(f'the segmentation head only upsamples: ({shape[2]}, {shape[3]}) '
                         f'cannot go to ({out_h}, {out_w})')


def _taps(n_in: int, n_out: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Source index pairs and upper weights along one axis (align_corners=False)."""
    scale = torch.tensor(n_in, dtype=torch.float32) / torch.tensor(n_out, dtype=torch.float32)
    o = torch.arange(n_out, dtype=torch.float32, device=device)
    f = torch.clamp((o + 0.5) * scale.to(device) - 0.5, min=0.0)
    i0 = torch.clamp(f.to(torch.int64), max=n_in - 1)
    i1 = torch.clamp(i0 + 1, max=n_in - 1)
    return i0, i1, f - i0.to(torch.float32)


def seg_head_reference(logits: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """
    Plain PyTorch version of :func:`seg_head`.

    Args:
        logits: (N, K, h, w) network output in any float type.
        out_h, out_w: output size, at least (h, w).

    Returns:
        (N, K, out_h, out_w) float32 sigmoid probabilities.
    """
    _check_upsampling(logits.shape, out_h, out_w)
    x = logits.to(torch.float32)
    y0, y1, ly = _taps(x.shape[2], out_h, x.device)
    x0, x1, lx = _taps(x.shape[3], out_w, x.device)
    top, bot = x[:, :, y0], x[:, :, y1]
    ly = ly[:, None]
    v = (1 - ly) * ((1 - lx) * top[..., x0] + lx * top[..., x1]) \
        + ly * ((1 - lx) * bot[..., x0] + lx * bot[..., x1])
    return torch.sigmoid(v)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The kernel's C entry point, with its argument types (built at first use)."""
    from kraken_tpu_torch.ops.build import load_library
    fn = load_library('seghead').seghead_forward
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def geometry(h: int, w: int, out_h: int, out_w: int) -> tuple[int, int, int, int]:
    """
    The block shape the kernel takes for (h, w) -> (out_h, out_w), as its
    source computes it: (output columns a block takes, staged input rows,
    staged input columns, dynamic shared memory in bytes). Builds the kernel
    library; needs no card.
    """
    from kraken_tpu_torch.ops.build import load_library
    fn = load_library('seghead').seghead_geometry
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    out = [ctypes.c_int() for _ in range(4)]
    err = fn(h, w, out_h, out_w, *map(ctypes.byref, out))
    if err != 0:
        raise ValueError(f'seghead_geometry refused ({h}, {w}) -> ({out_h}, {out_w})')
    return tuple(v.value for v in out)


def seg_head(logits: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """
    Bilinear upsampling plus sigmoid (same arguments and result as
    :func:`seg_head_reference`).

    On a CPU tensor this is the plain version. On a CUDA tensor it launches
    the kernel of ``csrc/seghead.cu`` on the current stream and adds one to
    ``seg_head.launches``; it raises on a type, shape, layout or device the
    kernel does not take (logits contiguous in float32, bfloat16 or
    float16), on a shrinking size, and when the launch is refused.
    """
    _check_upsampling(logits.shape, out_h, out_w)
    device = logits.device
    if device.type == 'cpu':
        return seg_head_reference(logits, out_h, out_w)
    if device.type != 'cuda':
        raise ValueError(f'seg_head runs on cpu or cuda tensors, not {device}')
    code = DTYPE_CODES.get(logits.dtype)
    if code is None:
        raise TypeError(f'logits must be float32, bfloat16 or float16, not {logits.dtype}')
    if not logits.is_contiguous():
        raise ValueError('logits must be contiguous')
    N, K, h, w = logits.shape
    y = torch.empty((N, K, out_h, out_w), dtype=torch.float32, device=device)
    if y.numel() == 0:
        return y
    err = _kernel()(logits.data_ptr(), y.data_ptr(), N, K, h, w, out_h, out_w, code,
                    device.index, raw_stream(device.index))
    if err != 0:
        raise RuntimeError(f'seg_head kernel launch failed: cudaError {err}')
    seg_head.launches += 1
    return y


seg_head.launches = 0
