"""
kraken_tpu_torch.ops.groupnorm
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

The padding-aware GroupNorm of the VGSL ``Gn`` layer, the port of the JAX
package's ``nn/layers.py:GroupNorm.apply`` (an XLA program there).

:func:`group_norm` normalises an (N, C, H, W) activation per sample and
group of C/G channels. With sequence lengths the statistics cover the
valid columns ``w < clamp(len, 1, W)`` only and the output is zero in the
columns beyond, so the next convolution reads zero padding; without them
every column is valid. The math is fp32 (population variance, eps inside
the square root); the output has the input's type.

On a CUDA tensor it launches the hand-written kernel of
``csrc/groupnorm.cu`` (built by :mod:`kraken_tpu_torch.ops.build`) or
raises; on a CPU tensor it runs :func:`group_norm_reference`, the plain
PyTorch version of the same function.
"""
import ctypes
import functools
from typing import Optional

import torch

from kraken_tpu_torch.ops.build import DTYPE_CODES

__all__ = ['group_norm', 'group_norm_reference', 'blocks_per_group']

# the kernel's launch aims at about this many blocks (8 per SM of an H100)
_TARGET_BLOCKS = 8 * 132


def group_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         num_groups: int, eps: float = 1e-5,
                         seq_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """
    Plain PyTorch version of :func:`group_norm`: masked mean and variance
    over the valid columns, then normalise, affine and zero the pad
    columns.

    Args:
        x: (N, C, H, W) activations.
        weight, bias: (C,) affine parameters.
        num_groups: G, a divisor of C.
        eps: added to the variance.
        seq_len: (N,) valid widths, or None (every column valid).

    Returns:
        (N, C, H, W) in the type of `x`.
    """
    t = x.dtype
    x32 = x.to(torch.float32)
    N, C, H, W = x32.shape
    G = num_groups
    grouped = x32.reshape(N, G, C // G, H, W)
    if seq_len is None:
        mean = grouped.mean(dim=(2, 3, 4), keepdim=True)
        var = grouped.var(dim=(2, 3, 4), keepdim=True, correction=0)
        normed = (grouped - mean) * torch.rsqrt(var + eps)
    else:
        lens = torch.clamp(seq_len, 1, W)
        mask = (torch.arange(W, device=x.device)[None, :] < lens[:, None]).to(torch.float32)
        m = mask[:, None, None, None, :]
        count = ((C // G) * H * lens.to(torch.float32))[:, None, None, None, None]
        mean = (grouped * m).sum(dim=(2, 3, 4), keepdim=True) / count
        var = (((grouped - mean) ** 2) * m).sum(dim=(2, 3, 4), keepdim=True) / count
        normed = (grouped - mean) * torch.rsqrt(var + eps)
        normed = normed * m
    normed = normed.reshape(N, C, H, W)
    y = normed * weight.to(torch.float32)[None, :, None, None] \
        + bias.to(torch.float32)[None, :, None, None]
    if seq_len is not None:
        valid = torch.arange(W, device=x.device)[None, None, None, :] \
            < torch.clamp(seq_len, 1, W)[:, None, None, None]
        y = y * valid
    return y.to(t)


def blocks_per_group(groups: int, rows: int) -> int:
    """
    S, the blocks the kernel splits each of `groups` groups of `rows` rows
    into: about ``_TARGET_BLOCKS`` blocks in all, at least 8 rows (one per
    warp) a block, and no block without a row.
    """
    S = max(1, min(-(-_TARGET_BLOCKS // groups), -(-rows // 8)))
    return -(-rows // -(-rows // S))


@functools.lru_cache(maxsize=None)
def _kernel():
    """The kernel's C entry point, with its argument types (built at first use)."""
    from kraken_tpu_torch.ops.build import load_library
    fn = load_library('groupnorm').groupnorm_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float] \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-5,
               seq_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """
    The padding-aware GroupNorm (same arguments and result as
    :func:`group_norm_reference`).

    On a CPU tensor this is the plain version. On a CUDA tensor it runs the
    kernel of ``csrc/groupnorm.cu`` on the current stream (two launches: the
    partial statistics, then the merge and normalisation) and adds two to
    ``group_norm.launches``; it raises on a type, shape, layout or device
    the kernel does not take and when a launch is refused. The kernel takes
    `x` contiguous in float32, bfloat16 or float16; `weight` and `bias` are
    read in float32 (a copy is made when they are in another type) and
    `seq_len` as int32.
    """
    if x.device.type == 'cpu':
        return group_norm_reference(x, weight, bias, num_groups, eps, seq_len)
    if x.device.type != 'cuda':
        raise ValueError(f'group_norm runs on cpu or cuda tensors, not {x.device}')
    if x.dim() != 4:
        raise ValueError(f'x must be (N, C, H, W), got {tuple(x.shape)}')
    N, C, H, W = x.shape
    if num_groups <= 0 or C % num_groups:
        raise ValueError(f'{num_groups} groups do not divide {C} channels')
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f'x must be float32, bfloat16 or float16, not {x.dtype}')
    if not x.is_contiguous():
        raise ValueError('x must be contiguous')
    if tuple(weight.shape) != (C,) or tuple(bias.shape) != (C,):
        raise ValueError(f'weight and bias must be ({C},)')
    tensors = [weight, bias] + ([seq_len] if seq_len is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError('x, weight, bias and seq_len must lie on one device')
    if seq_len is not None:
        if tuple(seq_len.shape) != (N,):
            raise ValueError(f'seq_len must be ({N},), got {tuple(seq_len.shape)}')
        seq_len = seq_len.to(torch.int32).contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    G = num_groups
    S = blocks_per_group(N * G, (C // G) * H)
    partial = torch.empty((N * G * S * 3,), dtype=torch.float32, device=x.device)
    w32 = weight.to(torch.float32).contiguous()
    b32 = bias.to(torch.float32).contiguous()
    fn = _kernel()
    err = fn(x.data_ptr(), seq_len.data_ptr() if seq_len is not None else None,
             partial.data_ptr(), w32.data_ptr(), b32.data_ptr(), y.data_ptr(),
             N, C, H, W, G, S, float(eps), DTYPE_CODES[x.dtype], x.device.index,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'group_norm kernel launch failed: cudaError {err}')
    group_norm.launches += 2  # statistics, then merge + normalise
    return y


group_norm.launches = 0
