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

The source holds two designs, picked per call from the shapes alone by
:func:`_design`: ``cluster`` (one launch) holds each (sample, group) in the
shared memory of a thread-block cluster, so x is read once (every layer of
the shipped segmentation model); ``stream`` (two launches: the partial
statistics, then their merge and the normalisation) reads x twice, for
groups a cluster cannot hold. A refused launch raises; neither design stands
in for the other.

Training: where grad mode is on and `x`, `weight` or `bias` require a
gradient, :func:`group_norm` on a CUDA tensor runs
:class:`GroupNormFunction`: either design also writes each (sample,
group)'s mean and rstd, and the two backward launches of
``csrc/groupnorm.cu`` give dx (zero at the pad columns) and the per-(sample,
channel) sums of the affine's gradients (counter
``group_norm.backward_launches``, 2 a call), float32 only. On a CPU tensor
the plain version's torch autograd is the gradient.
"""
import ctypes
import functools
from typing import Optional

import torch

from kraken_tpu_torch.ops.build import DTYPE_CODES, raw_stream

__all__ = ['GroupNormFunction', 'group_norm', 'group_norm_reference', 'blocks_per_group',
           'cluster_occupancy']

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


# What the cluster design may use on an H100 (sm_90): dynamic shared memory
# per CTA (the 232,448 bytes a block may take, less 1 KB for the kernel's
# static shared memory) and the cluster sizes it tries (8 is portable, 16
# needs the non-portable opt-in). Mirrors csrc/groupnorm.cu:cluster_smem;
# chip_smoke.py checks the mirror against the card.
SMEM_PER_CTA = 232448 - 1024
CLUSTER_SIZES = (8, 16)
_ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}


def _cluster_smem(rows: int, W: int, dtype: torch.dtype) -> int:
    """Bytes of dynamic shared memory a CTA of the cluster design takes to
    hold up to `rows` rows of W elements: the rows in x's own type from the
    16-byte line that holds their first element, in whole 16-byte lines with
    room for both ragged ends, then each row's fp32 weight and bias."""
    return (rows * W * _ELEMENT_BYTES[dtype] + 32 + 15) // 16 * 16 + 8 * rows


def _cta_rows(rows: int, CL: int, rank: int) -> range:
    """The rows of a group that CTA `rank` of a cluster of CL takes."""
    return range(rank * rows // CL, (rank + 1) * rows // CL)


@functools.lru_cache(maxsize=256)
def _design(N: int, C: int, H: int, W: int, G: int, dtype: torch.dtype) -> tuple:
    """
    The kernel design for a call, from its shapes alone:
    ``('cluster', CL, R)`` holds each of the N*G groups in a cluster of CL
    CTAs of at most R rows each; ``('stream',)`` reads each group twice, for
    groups whose rows do not fit a cluster's shared memory.

    CL is the smallest cluster size of :data:`CLUSTER_SIZES` (at most the
    group's Cg*H rows) whose CTAs hold their rows.
    """
    rows = (C // G) * H
    for size in CLUSTER_SIZES:
        CL = min(size, rows)
        R = -(-rows // CL)
        if _cluster_smem(R, W, dtype) <= SMEM_PER_CTA:
            return ('cluster', CL, R)
    return ('stream',)


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel library with the argument types of its entry points
    (built at first use)."""
    from kraken_tpu_torch.ops.build import load_library
    lib = load_library('groupnorm')
    lib.groupnorm_forward.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
        + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.groupnorm_cluster.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
        + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.groupnorm_cluster_occupancy.argtypes = [ctypes.c_int] * 7 \
        + [ctypes.POINTER(ctypes.c_int)] * 3
    lib.groupnorm_backward.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    for fn in (lib.groupnorm_forward, lib.groupnorm_cluster, lib.groupnorm_cluster_occupancy,
               lib.groupnorm_backward):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def cluster_occupancy(C: int, H: int, W: int, G: int, CL: int, dtype: torch.dtype,
                      device: int = 0) -> tuple[int, int, int]:
    """
    What the cluster design asks of the card for groups of (C, H, W) in G
    groups with clusters of CL, as the kernel source computes it: (dynamic
    shared memory per CTA in bytes, threads per CTA, clusters of this shape
    the card holds at once, from ``cudaOccupancyMaxActiveClusters``; 0 when
    it cannot run one). Builds the kernel library; needs a card.
    """
    smem, threads, clusters = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _lib().groupnorm_cluster_occupancy(C, H, W, G, CL, DTYPE_CODES[dtype], device,
                                             ctypes.byref(smem), ctypes.byref(threads),
                                             ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError(f'group_norm cluster design refused for C={C} H={H} W={W} G={G} '
                           f'CL={CL} {dtype}: cudaError {err}')
    return smem.value, threads.value, clusters.value


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int,
            eps: float, seq_len: Optional[torch.Tensor], design: tuple,
            stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launches ``design`` of ``csrc/groupnorm.cu`` on checked CUDA tensors
    and counts its launches; raises if the card cannot hold the cluster
    design's shape or a launch is refused. `stats`, an (N, G, 2) float32
    buffer, makes the kernel write each group's (mean, rstd) for the
    backward."""
    N, C, H, W = x.shape
    G = num_groups
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    dev = x.device.index
    lens = seq_len.data_ptr() if seq_len is not None else None
    w32 = weight.to(torch.float32).contiguous()  # no copy when already fp32
    b32 = bias.to(torch.float32).contiguous()
    stats_ptr = None if stats is None else stats.data_ptr()
    if design[0] == 'cluster':
        CL = design[1]
        if cluster_occupancy(C, H, W, G, CL, x.dtype, dev)[2] == 0:
            raise RuntimeError(f'group_norm: the card cannot hold a cluster of {CL} CTAs for '
                               f'groups of {(N, C, H, W)} / {G} in {x.dtype}')
        err = _lib().groupnorm_cluster(x.data_ptr(), lens, w32.data_ptr(), b32.data_ptr(),
                                       y.data_ptr(), stats_ptr, N, C, H, W, G, CL, float(eps),
                                       DTYPE_CODES[x.dtype], dev, raw_stream(dev))
        launches = 1
    else:
        S = blocks_per_group(N * G, (C // G) * H)
        partial = torch.empty((N * G * S * 3,), dtype=torch.float32, device=x.device)
        err = _lib().groupnorm_forward(x.data_ptr(), lens, partial.data_ptr(), w32.data_ptr(),
                                       b32.data_ptr(), y.data_ptr(), stats_ptr, N, C, H, W, G, S,
                                       float(eps), DTYPE_CODES[x.dtype], dev, raw_stream(dev))
        launches = 2  # statistics, then merge + normalise
    if err != 0:
        raise RuntimeError(f'group_norm {design[0]} kernel launch failed: cudaError {err}')
    group_norm.launches += launches
    group_norm.design_launches[design[0]] += launches
    return y


def _launch_backward(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor, num_groups: int,
                     seq_len: Optional[torch.Tensor], stats: torch.Tensor) -> tuple:
    """Launches the two backward kernels of ``csrc/groupnorm.cu`` on
    float32 CUDA tensors and counts them: (dx, d weight, d bias), the
    affine's gradients summed over the samples with torch."""
    N, C, H, W = x.shape
    G = num_groups
    dx = torch.empty_like(x)
    S1 = blocks_per_group(N * C, H)
    S2 = blocks_per_group(N * G, (C // G) * H)
    partial = torch.empty((N, C, S1, 2), dtype=torch.float32, device=x.device)
    dev = x.device.index
    w32 = weight.to(torch.float32).contiguous()
    err = _lib().groupnorm_backward(x.data_ptr(), dy.data_ptr(),
                                    None if seq_len is None else seq_len.data_ptr(),
                                    stats.data_ptr(), w32.data_ptr(), partial.data_ptr(),
                                    dx.data_ptr(), N, C, H, W, G, S1, S2, dev, raw_stream(dev))
    if err != 0:
        raise RuntimeError(f'group_norm backward kernel launch failed: cudaError {err}')
    group_norm.backward_launches += 2
    sums = partial.sum(dim=(0, 2))
    return dx, sums[:, 0], sums[:, 1]


class GroupNormFunction(torch.autograd.Function):
    """
    :func:`group_norm` with a gradient, on float32 CUDA tensors: the
    forward kernel also writes each (sample, group)'s mean and rstd, the
    backward kernels of ``csrc/groupnorm.cu`` give dx over the valid
    columns (zero at the pad columns, which the forward zeroes) and the
    per-(sample, channel) sums of the affine's gradients, which torch sums
    over the samples.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, seq_len):
        N, C, H, W = x.shape
        stats = torch.empty((N, num_groups, 2), dtype=torch.float32, device=x.device)
        y = _launch(x, weight, bias, num_groups, eps, seq_len,
                    _design(N, C, H, W, num_groups, x.dtype), stats)
        ctx.num_groups = num_groups
        ctx.save_for_backward(x, weight, seq_len, stats)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, seq_len, stats = ctx.saved_tensors
        dx, d_weight, d_bias = _launch_backward(x, dy.contiguous(), weight, ctx.num_groups,
                                                seq_len, stats)
        return dx, d_weight.to(weight.dtype), d_bias.to(weight.dtype), None, None, None


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-5,
               seq_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """
    The padding-aware GroupNorm (same arguments and result as
    :func:`group_norm_reference`).

    On a CPU tensor this is the plain version. On a CUDA tensor it runs the
    design of ``csrc/groupnorm.cu`` that :func:`_design` picks for the
    shapes, on the current stream, and adds its device launches (1 for
    ``cluster``, 2 for ``stream``) to ``group_norm.launches`` and to the
    design's entry of ``group_norm.design_launches``; it raises on a type,
    shape, layout or device the kernel does not take and when a launch is
    refused. The kernel takes `x` contiguous in float32, bfloat16 or
    float16; `weight` and `bias` are read in float32 (a copy is made when
    they are in another type) and `seq_len` as int32.
    """
    device = x.device
    if device.type == 'cpu':
        return group_norm_reference(x, weight, bias, num_groups, eps, seq_len)
    if device.type != 'cuda':
        raise ValueError(f'group_norm runs on cpu or cuda tensors, not {device}')
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
    if weight.device != device or bias.device != device or \
            (seq_len is not None and seq_len.device != device):
        raise ValueError('x, weight, bias and seq_len must lie on one device')
    if seq_len is not None:
        if tuple(seq_len.shape) != (N,):
            raise ValueError(f'seq_len must be ({N},), got {tuple(seq_len.shape)}')
        seq_len = seq_len.to(torch.int32).contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        if x.dtype != torch.float32 or weight.dtype != torch.float32:
            raise TypeError('the GroupNorm gradient is float32 only: training runs in float32 '
                            'whatever the precision')
        return GroupNormFunction.apply(x, weight, bias, num_groups, eps, seq_len)
    return _launch(x, weight, bias, num_groups, eps, seq_len,
                   _design(N, C, H, W, num_groups, x.dtype))


group_norm.launches = 0
group_norm.design_launches = {'cluster': 0, 'stream': 0}
group_norm.backward_launches = 0
