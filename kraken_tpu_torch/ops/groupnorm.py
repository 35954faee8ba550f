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
group)'s mean and rstd, and one backward launch of ``csrc/groupnorm.cu``
gives dx (zero at the pad columns) and the partial sums of the affine's
gradients, float32 only. Its route comes from the shapes
(:func:`_backward_design`): ``cluster`` holds each group's x and dy in a
cluster's shared memory (read once), ``l2`` reads each group twice in one
cooperative launch that keeps few enough groups in flight for the second
read to find them in L2. Counters ``group_norm.backward_launches`` (1 a
call) and ``group_norm.backward_design_launches``. On a CPU tensor the
plain version's torch autograd is the gradient.
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


def _bwd_cluster_smem(rows: int, W: int, Cg: int) -> int:
    """Bytes of dynamic shared memory a CTA of the backward's cluster route
    takes for up to `rows` rows of W elements: the rows of x and of dy in
    fp32 (each as :func:`_cluster_smem` lays them out), each row's weight
    and the CTA's (A, B) of each of the group's Cg channels."""
    return 2 * ((rows * W * 4 + 32 + 15) // 16 * 16) + 4 * rows + 8 * Cg


# the backward's cluster sizes, and the shared memory a CTA may take for
# three of them to share an SM (233,472 bytes an SM, 1 KB of each CTA the
# system's, 1 KB of static shared memory)
BWD_CLUSTER_SIZES = (1, 2, 4, 8, 16)
BWD_SMEM_SHARED = 233472 // 3 - 2048


@functools.lru_cache(maxsize=256)
def _backward_design(N: int, C: int, H: int, W: int, G: int) -> tuple:
    """
    The backward kernel's route for a call, from its shapes alone:
    ``('cluster', CL, R)`` holds each group's x and dy in a cluster of CL
    CTAs of at most R rows each (x and dy read once); ``('l2',)`` reads each
    group twice, the second time from L2, in one cooperative launch (groups
    whose x and dy no cluster holds).

    CL is the smallest of :data:`BWD_CLUSTER_SIZES` (at most the group's
    rows) whose CTAs take at most :data:`BWD_SMEM_SHARED` (three CTAs an
    SM, so that one's copies overlap another's arithmetic), else the
    smallest whose CTAs fit at all.
    """
    rows, Cg = (C // G) * H, C // G
    for limit in (BWD_SMEM_SHARED, SMEM_PER_CTA):
        for size in BWD_CLUSTER_SIZES:
            CL = min(size, rows)
            R = -(-rows // CL)
            if _bwd_cluster_smem(R, W, Cg) <= limit:
                return ('cluster', CL, R)
    return ('l2',)


# the l2 route's launch: L2_CTAS_PER_SM CTAs an SM (264 on an H100), items
# of at least L2_ITEM elements of one channel plane (a multiple of 4). A CTA
# sums its next item before it waits for its current one's group, so two
# items a CTA lie between their two reads: 264 * 2 * 8192 * 8 bytes = 35 MB
# of x and dy, within the 50 MB L2 (on an H100 items of 4096, 17 MB in
# flight, took 5.5% longer at segtrain's first layer, items of 16384, 69 MB,
# more than the L2 holds, 3.3% longer: PERF.md)
L2_CTAS_PER_SM = 2
L2_ITEM = 8192


def _l2_plan(N: int, C: int, H: int, W: int, G: int,
             capacity: int) -> tuple[int, int, int, int]:
    """
    The l2 route's launch on a card that takes a cooperative grid of
    `capacity` CTAs: (per, S, K, grid), items of `per` elements, S items a
    plane, works of K items, `grid` CTAs. A group's works must all be in
    flight at once: per grows past L2_ITEM where a group has more than
    `capacity` items of L2_ITEM, and K where even a plane an item leaves
    more items than that (groups of more channels than CTAs).
    """
    Cg, HW = C // G, H * W
    per = max(L2_ITEM, -(-HW // max(1, capacity // Cg)))
    per = -(-per // 4) * 4
    S = -(-HW // per)
    K = -(-Cg * S // capacity)
    return per, S, K, min(capacity, N * G * -(-Cg * S // K))


@functools.lru_cache(maxsize=None)
def _l2_capacity(device: int) -> int:
    """The l2 route's grid on the card: L2_CTAS_PER_SM an SM, or fewer
    where the kernel source's occupancy query (the largest cooperative
    grid) says so."""
    blocks = ctypes.c_int()
    err = _lib().groupnorm_bwd_l2_capacity(device, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f'groupnorm_bwd_l2_capacity failed: cudaError {err}')
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(blocks.value, L2_CTAS_PER_SM * sms)


# the l2 route's flags, one int32 an item, kept per (device, stream) and
# never reset: each launch writes and waits for a new epoch. A replay of a
# captured launch would find its own epoch already written and read the
# last replay's partials, so _launch_backward refuses to be captured.
_FLAGS: dict = {}


def _flags(device: torch.device, stream: int, items: int) -> tuple[torch.Tensor, int]:
    """The flag buffer of (device, stream), at least `items` long, and the
    epoch of the next launch (1, 2, ...; a new buffer is zero)."""
    key = (device.index, stream)
    buf, epoch = _FLAGS.get(key, (None, 0))
    if buf is None or buf.numel() < items:
        buf, epoch = torch.zeros(max(items, 1 << 16), dtype=torch.int32, device=device), 0
    epoch = epoch % 0x7ffffffe + 1
    _FLAGS[key] = (buf, epoch)
    return buf, epoch


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
    lib.groupnorm_backward_cluster.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    lib.groupnorm_bwd_cluster_occupancy.argtypes = [ctypes.c_int] * 6 \
        + [ctypes.POINTER(ctypes.c_int)] * 3
    lib.groupnorm_backward_l2.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] \
        + [ctypes.c_void_p] + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.groupnorm_bwd_l2_capacity.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    for fn in (lib.groupnorm_forward, lib.groupnorm_cluster, lib.groupnorm_cluster_occupancy,
               lib.groupnorm_backward_cluster, lib.groupnorm_bwd_cluster_occupancy,
               lib.groupnorm_backward_l2, lib.groupnorm_bwd_l2_capacity):
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


@functools.lru_cache(maxsize=256)
def bwd_cluster_occupancy(C: int, H: int, W: int, G: int, CL: int,
                          device: int = 0) -> tuple[int, int, int]:
    """:func:`cluster_occupancy` of the backward's cluster route (fp32).
    Needs a card."""
    smem, threads, clusters = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _lib().groupnorm_bwd_cluster_occupancy(C, H, W, G, CL, device, ctypes.byref(smem),
                                                 ctypes.byref(threads), ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError(f'group_norm backward cluster route refused for C={C} H={H} W={W} '
                           f'G={G} CL={CL}: cudaError {err}')
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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a copy of it where its data does not start on 16 bytes (a
    view into a larger storage): the backward loads 16 bytes at a time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_backward(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor, num_groups: int,
                     seq_len: Optional[torch.Tensor], stats: torch.Tensor,
                     design: tuple) -> tuple:
    """Launches ``design`` of the backward kernel of ``csrc/groupnorm.cu``
    on float32 CUDA tensors and counts the launch; raises if it is refused,
    and for the l2 route while the stream is captured into a CUDA graph (its
    flags hold an epoch a launch, which a replay would repeat): (dx,
    d weight, d bias), the affine's gradients summed over the samples and
    the kernel's partials with torch."""
    N, C, H, W = x.shape
    G = num_groups
    x, dy = _aligned(x), _aligned(dy)
    dx = torch.empty_like(x)
    dev = x.device.index
    w32 = weight.to(torch.float32).contiguous()
    lens = None if seq_len is None else seq_len.data_ptr()
    stream = raw_stream(dev)
    if design[0] == 'cluster':
        CL = design[1]
        if bwd_cluster_occupancy(C, H, W, G, CL, dev)[2] == 0:
            raise RuntimeError(f'group_norm backward: the card cannot hold a cluster of {CL} CTAs '
                               f'for groups of {(N, C, H, W)} / {G}')
        partial = torch.empty((N, G, CL, C // G, 2), dtype=torch.float32, device=x.device)
        err = _lib().groupnorm_backward_cluster(x.data_ptr(), dy.data_ptr(), lens, stats.data_ptr(),
                                                w32.data_ptr(), partial.data_ptr(), dx.data_ptr(),
                                                N, C, H, W, G, CL, dev, stream)
        sums = partial.sum(dim=(0, 2)).reshape(C, 2)
    else:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError('the GroupNorm backward\'s l2 route cannot be captured in a CUDA '
                               'graph: a replay would reuse its launch\'s flag epoch')
        per, S, K, grid = _l2_plan(N, C, H, W, G, _l2_capacity(dev))
        partial = torch.empty((N, C, S, 2), dtype=torch.float32, device=x.device)
        flags, epoch = _flags(x.device, stream, N * C * S)
        err = _lib().groupnorm_backward_l2(x.data_ptr(), dy.data_ptr(), lens, stats.data_ptr(),
                                           w32.data_ptr(), partial.data_ptr(), flags.data_ptr(),
                                           epoch, dx.data_ptr(), N, C, H, W, G, per, K, grid,
                                           dev, stream)
        sums = partial.sum(dim=(0, 2))
    if err != 0:
        raise RuntimeError(f'group_norm backward {design[0]} kernel launch failed: cudaError {err}')
    group_norm.backward_launches += 1
    group_norm.backward_design_launches[design[0]] += 1
    return dx, sums[:, 0], sums[:, 1]


class GroupNormFunction(torch.autograd.Function):
    """
    :func:`group_norm` with a gradient, on float32 CUDA tensors: the
    forward kernel also writes each (sample, group)'s mean and rstd, the
    backward kernel of ``csrc/groupnorm.cu`` (one launch) gives dx over the
    valid columns (zero at the pad columns, which the forward zeroes) and
    partial sums of the affine's gradients, which torch sums.
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
        N, C, H, W = x.shape
        dx, d_weight, d_bias = _launch_backward(x, dy.contiguous(), weight, ctx.num_groups,
                                                seq_len, stats,
                                                _backward_design(N, C, H, W, ctx.num_groups))
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
group_norm.backward_design_launches = {'cluster': 0, 'l2': 0}
