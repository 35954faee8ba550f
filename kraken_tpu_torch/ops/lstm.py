"""
kraken_tpu_torch.ops.lstm
~~~~~~~~~~~~~~~~~~~~~~~~~

The LSTM recurrence: the port of the JAX package's only TPU kernel,
``kraken_tpu/ops/lstm.py:lstm_pallas``.

:func:`lstm_recurrence` runs the recurrence over precomputed input
projections. On a CUDA tensor it launches a hand-written Hopper kernel of
``csrc/lstm.cu`` (built by :mod:`kraken_tpu_torch.ops.build`) or raises; on
a CPU tensor it runs :func:`lstm_recurrence_reference`, the plain PyTorch
version of the same function. The input projection ``x @ w_ih^T + b`` is a
large matrix product and stays outside, in ``torch.matmul``, as the JAX
package keeps it outside its kernel.

The source holds two designs, picked per call from the shapes alone by
:func:`_design`: ``cluster`` keeps ``w_hh`` in the shared memory of a
thread-block cluster and exchanges ``h`` through distributed shared memory
(every hidden size a cluster holds, up to about 460, so every shipped
model); ``stream`` reads ``w_hh`` from L2 on every step (larger hidden
sizes, up to 1024). A refused launch raises; neither design stands in for
the other.

Semantics, shared by both versions (those of the Pallas kernel): per step
t of one direction ``gates = gates_x[:, t] + h @ w_hh^T`` with gate order
i, f, g, o; ``c' = σ(f)·c + σ(i)·tanh(g)``, ``h' = σ(o)·tanh(c')``. Where
``mask[:, t]`` is false the carry is frozen and the output is 0 (torch
packed-sequence semantics); a reversed direction walks t from T-1 to 0 with
the same un-flipped mask. The carry and the recurrent product are float32
whatever the type of ``gates_x``; the output has the type of ``gates_x``.

Both directions of a bidirectional layer go through one call (and one
kernel launch): ``gates_x`` is (B, T, D, 4H) with D = 2, ``w_hh`` is
(D, 4H, H), and direction 1 runs opposite to direction 0.

With ``peephole`` (D, 3, H), the weights (w_ip, w_fp, w_op) of each
direction, the cell is the legacy ocropy peephole LSTM, the counterpart of
the JAX package's ``nn/layers.py:_peephole_scan``:
``i = σ(i + w_ip·c)``, ``f = σ(f + w_fp·c)``, ``c' = f·c + i·tanh(g)``,
``o = σ(o + w_op·c')``, ``h' = o·tanh(c')``. Both designs take it as a
template flag of the same source. The JAX scan carries ``h``/``c`` in the
input's type; here the carry stays float32, so the two are the same
function in fp32 and the port is the more precise one in bf16.
"""
import ctypes
import functools
from typing import Optional

import torch

from kraken_tpu_torch.ops.build import DTYPE_CODES

__all__ = ['lstm_recurrence', 'lstm_recurrence_reference']


def _shapes(gates_x: torch.Tensor, w_hh: torch.Tensor, mask: torch.Tensor,
            peephole: Optional[torch.Tensor] = None) -> tuple[int, int, int, int]:
    if gates_x.dim() != 4:
        raise ValueError(f'gates_x must be (B, T, D, 4H), got {tuple(gates_x.shape)}')
    B, T, D, G = gates_x.shape
    if D not in (1, 2) or G % 4:
        raise ValueError(f'gates_x must be (B, T, D, 4H) with D in (1, 2), '
                         f'got {tuple(gates_x.shape)}')
    H = G // 4
    if tuple(w_hh.shape) != (D, G, H):
        raise ValueError(f'w_hh must be (D, 4H, H) = {(D, G, H)}, got {tuple(w_hh.shape)}')
    if tuple(mask.shape) != (B, T):
        raise ValueError(f'mask must be (B, T) = {(B, T)}, got {tuple(mask.shape)}')
    if peephole is not None and tuple(peephole.shape) != (D, 3, H):
        raise ValueError(f'peephole must be (D, 3, H) = {(D, 3, H)}, got {tuple(peephole.shape)}')
    return B, T, D, H


def lstm_recurrence_reference(gates_x: torch.Tensor, w_hh: torch.Tensor,
                              mask: torch.Tensor, reverse: bool = False,
                              peephole: Optional[torch.Tensor] = None) -> torch.Tensor:
    """
    Plain PyTorch version of :func:`lstm_recurrence`: a Python loop over
    the time axis, float32 carry and recurrent product.

    Args:
        gates_x: (B, T, D, 4H) input projections incl. biases.
        w_hh: (D, 4H, H) torch-convention recurrent weights.
        mask: (B, T) validity mask (nonzero = valid).
        reverse: direction 0 walks the time axis back to front; direction
            1 (if any) walks it the other way.
        peephole: (D, 3, H) peephole weights (w_ip, w_fp, w_op) of the
            ocropy cell, or None for the plain cell.

    Returns:
        (B, T, D, H) hidden states, zero at masked steps.
    """
    B, T, D, H = _shapes(gates_x, w_hh, mask, peephole)
    valid = (mask != 0)[:, :, None]
    out = torch.zeros((B, T, D, H), dtype=gates_x.dtype, device=gates_x.device)
    for d in range(D):
        w_t = w_hh[d].to(torch.float32).t()
        if peephole is not None:
            w_ip, w_fp, w_op = peephole[d].to(torch.float32)
        h = torch.zeros((B, H), dtype=torch.float32, device=gates_x.device)
        c = torch.zeros_like(h)
        steps = range(T - 1, -1, -1) if (d == 1) != reverse else range(T)
        for t in steps:
            gates = gates_x[:, t, d].to(torch.float32) + h @ w_t
            i, f, g, o = gates.chunk(4, dim=1)
            if peephole is None:
                c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h_new = torch.sigmoid(o) * torch.tanh(c_new)
            else:
                c_new = (torch.sigmoid(f + w_fp * c) * c
                         + torch.sigmoid(i + w_ip * c) * torch.tanh(g))
                h_new = torch.sigmoid(o + w_op * c_new) * torch.tanh(c_new)
            m = valid[:, t]
            c = torch.where(m, c_new, c)
            h = torch.where(m, h_new, h)
            out[:, t, d] = torch.where(m, h_new, 0.0).to(gates_x.dtype)
    return out


# What the cluster design may use on an H100 (sm_90, 132 SMs): dynamic
# shared memory per CTA, the cluster sizes it tries (8 is portable, 16 needs
# the non-portable opt-in), the clusters of each size the card runs at once
# with one CTA per SM (cudaOccupancyMaxActiveClusters, see
# cluster_occupancy, which chip_smoke.py checks), and the (unit, row) slots
# a CTA of 512 threads takes, 4 a thread. Mirrors csrc/lstm.cu:cluster_shape.
SMEM_PER_CTA = 232448
CLUSTER_SIZES = (8, 16)
WAVE_CLUSTERS = {8: 15, 16: 7}
MAX_SLOTS = 2048
MAX_HIDDEN = 1024


def _padded_h(H: int) -> int:
    """Row stride of w_hh and h in the kernel's shared memory, in float4:
    at least H and 4 mod 8 (conflict-free shared loads)."""
    return H + (12 - H % 8) % 8


def _cluster_smem(H: int, C: int, R: int) -> int:
    """Bytes of shared memory one CTA of the cluster design takes: its
    w_hh slice (4 gates of ceil(H/C) units), h of R rows double-buffered
    and c of its units, all fp32, and one mbarrier per h buffer."""
    units, hp = -(-H // C), _padded_h(H)
    return 16 * (units * hp + 2 * (R // 4) * hp) + 4 * units * R + 16


def _units(H: int, C: int, rank: int) -> range:
    """The hidden units CTA ``rank`` of a cluster of C owns."""
    return range(rank * H // C, (rank + 1) * H // C)


@functools.lru_cache(maxsize=256)
def _design(B: int, T: int, D: int, H: int) -> tuple:
    """
    The kernel design for a call, from its shapes alone:
    ``('cluster', C, R)`` keeps w_hh in the shared memory of a cluster of C
    CTAs, one cluster per tile of R rows and direction; ``('stream',)``
    streams w_hh from L2 every step, for hidden sizes whose w_hh does not
    fit a cluster.

    C is the smallest cluster size whose CTAs hold their w_hh slice and h
    of 4 rows. R is the least multiple of 4 that puts all
    ``ceil(B/R)·D`` clusters in one wave of the card, or else the largest
    R that fits the shared memory and the CTA's slots (more waves).
    """
    for C in CLUSTER_SIZES:
        units = -(-H // C)
        largest = None
        for R in range(4, MAX_SLOTS // units + 1, 4):
            if _cluster_smem(H, C, R) > SMEM_PER_CTA:
                break
            if -(-B // R) * D <= WAVE_CLUSTERS[C]:
                return ('cluster', C, R)
            largest = R
        if largest is not None:
            return ('cluster', C, largest)
    return ('stream',)


def cluster_occupancy(H: int, C: int, R: int, device: int = 0) -> tuple[int, int, int]:
    """
    What the cluster design asks of the card at (H, C, R), as the kernel
    source computes it: (dynamic shared memory per CTA in bytes, threads per
    CTA, clusters of this shape the card holds at once, from
    ``cudaOccupancyMaxActiveClusters``). Builds the kernel library; needs a
    card.
    """
    from kraken_tpu_torch.ops.build import load_library
    fn = load_library('lstm').lstm_cluster_occupancy
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    smem, threads, clusters = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = fn(H, C, R, device, ctypes.byref(smem), ctypes.byref(threads), ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError(f'lstm_cluster_occupancy failed: cudaError {err}')
    return smem.value, threads.value, clusters.value


def _launch(gates_x: torch.Tensor, w_hh: torch.Tensor, mask: torch.Tensor,
            reverse: bool, design: tuple, peephole: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launches ``design`` of ``csrc/lstm.cu`` on checked CUDA tensors and
    counts the launch; raises if the launch is refused. The peephole
    weights go to the kernel as a float32 (D, 3, H) copy."""
    B, T, D, H = _shapes(gates_x, w_hh, mask, peephole)
    out = torch.empty((B, T, D, H), dtype=gates_x.dtype, device=gates_x.device)
    if B == 0 or T == 0:
        return out
    from kraken_tpu_torch.ops.build import load_library
    lib = load_library('lstm')
    stream = torch.cuda.current_stream(gates_x.device).cuda_stream
    dev = gates_x.device.index
    peep = None if peephole is None else peephole.to(torch.float32).contiguous()
    peep_ptr = None if peep is None else peep.data_ptr()
    if design[0] == 'cluster':
        _, C, R = design
        fn = lib.lstm_recurrence_cluster
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(gates_x.data_ptr(), w_hh.data_ptr(), mask.data_ptr(), peep_ptr, out.data_ptr(),
                 B, T, D, H, C, R, int(bool(reverse)), DTYPE_CODES[gates_x.dtype],
                 DTYPE_CODES[w_hh.dtype], dev, stream)
    else:
        # the stream design reads w_hh transposed and in fp32
        w_hh_t = w_hh.to(torch.float32).transpose(1, 2).contiguous()
        fn = lib.lstm_recurrence_stream
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(gates_x.data_ptr(), w_hh_t.data_ptr(), mask.data_ptr(), peep_ptr,
                 out.data_ptr(), B, T, D, H, int(bool(reverse)), DTYPE_CODES[gates_x.dtype], dev,
                 stream)
    if err != 0:
        raise RuntimeError(f'lstm_recurrence {design[0]} kernel launch failed: cudaError {err}')
    lstm_recurrence.launches += 1
    lstm_recurrence.design_launches[design[0]] += 1
    if peep is not None:
        lstm_recurrence.peephole_launches += 1
    return out


def lstm_recurrence(gates_x: torch.Tensor, w_hh: torch.Tensor,
                    mask: torch.Tensor, reverse: bool = False,
                    peephole: Optional[torch.Tensor] = None) -> torch.Tensor:
    """
    The LSTM recurrence (same arguments and result as
    :func:`lstm_recurrence_reference`).

    On a CPU tensor this is the plain version. On a CUDA tensor it launches
    a kernel of ``csrc/lstm.cu`` on the current stream, the design that
    :func:`_design` picks for the shapes, and adds one to
    ``lstm_recurrence.launches`` and to the design's entry of
    ``lstm_recurrence.design_launches`` (with ``peephole``, the peephole
    variant of that design, also to ``lstm_recurrence.peephole_launches``);
    it raises on a type, shape, layout
    or device the kernel does not take and when the launch is refused. The
    kernel takes ``gates_x`` in float32, bfloat16 or float16 (contiguous),
    ``mask`` as contiguous bool and ``w_hh`` (contiguous) in float32,
    bfloat16 or float16: the cluster design reads it as it is, converting
    to float32 while it loads it into shared memory; the stream design
    (hidden sizes above what a cluster holds) is handed a transposed
    float32 copy (D, H, 4H), made on each call.
    """
    if gates_x.device.type == 'cpu':
        return lstm_recurrence_reference(gates_x, w_hh, mask, reverse, peephole)
    if gates_x.device.type != 'cuda':
        raise ValueError(f'lstm_recurrence runs on cpu or cuda tensors, not {gates_x.device}')
    B, T, D, H = _shapes(gates_x, w_hh, mask, peephole)
    if gates_x.dtype not in DTYPE_CODES or w_hh.dtype not in DTYPE_CODES:
        raise TypeError(f'gates_x and w_hh must be float32, bfloat16 or float16, '
                        f'not {gates_x.dtype} and {w_hh.dtype}')
    if mask.dtype != torch.bool:
        raise TypeError(f'mask must be bool, not {mask.dtype}')
    if not (gates_x.is_contiguous() and w_hh.is_contiguous() and mask.is_contiguous()):
        raise ValueError('gates_x, w_hh and mask must be contiguous')
    if w_hh.device != gates_x.device or mask.device != gates_x.device or (
            peephole is not None and peephole.device != gates_x.device):
        raise ValueError('gates_x, w_hh, mask and peephole must lie on one device')
    if peephole is not None and peephole.dtype not in DTYPE_CODES:
        raise TypeError(f'peephole must be float32, bfloat16 or float16, not {peephole.dtype}')
    if H > MAX_HIDDEN:
        raise ValueError(f'the kernel takes a hidden size of at most {MAX_HIDDEN}, not {H}')
    return _launch(gates_x, w_hh, mask, reverse, _design(B, T, D, H), peephole)


lstm_recurrence.launches = 0
lstm_recurrence.design_launches = {'cluster': 0, 'stream': 0}
lstm_recurrence.peephole_launches = 0
