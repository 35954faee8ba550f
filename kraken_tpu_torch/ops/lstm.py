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

Training: where grad mode is on and ``gates_x``, ``w_hh`` or the peephole
weights require a gradient, :func:`lstm_recurrence` on a CUDA tensor runs
:class:`LSTMRecurrence`: the forward kernel in its saving mode and the
backward kernel of ``csrc/lstm.cu`` in the design :func:`_backward_design`
picks from the shapes: ``cluster`` (w_hh in a cluster's shared memory,
partial sums of dh_carry exchanged through distributed shared memory; the
forward cluster design's hidden sizes) or ``stream`` (w_hh from L2 every
step, up to H = 1024). Counters ``lstm_recurrence.backward_launches``, by
design ``lstm_recurrence.backward_design_launches``, with the peephole
flag also ``lstm_recurrence.backward_peephole_launches``; float32 only.
On a CPU
tensor the plain version's torch autograd is the gradient; the backward
kernel is held to it on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 22).
"""
import ctypes
import functools
from typing import Optional

import torch

from kraken_tpu_torch.ops.build import DTYPE_CODES

__all__ = ['LSTMRecurrence', 'lstm_recurrence', 'lstm_recurrence_reference']


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


def _backward_smem(H: int, C: int, R: int) -> int:
    """Bytes of shared memory one CTA of the backward's cluster design
    takes: the forward's w_hh slice, the partial sums of dh_carry of its
    units received from each of the C CTAs and its own dgates (each R rows,
    double-buffered), all fp32, and one mbarrier per receive buffer."""
    units, hp, rg = -(-H // C), _padded_h(H), R // 4
    return 16 * (units * hp + 2 * C * units * rg + 2 * 4 * rg * units) + 16


def _backward_slots(H: int, C: int, R: int) -> int:
    """(unit, row) cells or (column, group of 4 rows) partials a step, the
    larger: what the backward's CTA spreads over its threads."""
    return max(-(-H // C) * R, H * (R // 4))


@functools.lru_cache(maxsize=256)
def _backward_design(B: int, T: int, D: int, H: int) -> tuple:
    """
    The backward kernel's design for a call, from its shapes alone, by the
    forward's rule (:func:`_design`) with the backward's shared memory:
    ``('cluster', C, R)`` holds w_hh in a cluster of C CTAs per tile of R
    rows and direction and exchanges partial sums of dh_carry;
    ``('stream',)`` reads w_hh from L2 every step (``lstm_backward_kernel``,
    hidden sizes whose slice no cluster holds, and those below 8, where a
    CTA of the cluster would own no unit).
    """
    for C in CLUSTER_SIZES:
        if C > H:
            break
        largest = None
        R = 4
        while _backward_slots(H, C, R) <= MAX_SLOTS and _backward_smem(H, C, R) <= SMEM_PER_CTA:
            if -(-B // R) * D <= WAVE_CLUSTERS[C]:
                return ('cluster', C, R)
            largest = R
            R += 4
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


def backward_cluster_occupancy(H: int, C: int, R: int, device: int = 0) -> tuple[int, int, int]:
    """:func:`cluster_occupancy` of the backward's cluster design (what
    ``csrc/lstm.cu:backward_cluster_shape`` computes, and
    ``cudaOccupancyMaxActiveClusters`` of its kernel). Needs a card."""
    from kraken_tpu_torch.ops.build import load_library
    fn = load_library('lstm').lstm_backward_cluster_occupancy
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    smem, threads, clusters = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = fn(H, C, R, device, ctypes.byref(smem), ctypes.byref(threads), ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError(f'lstm_backward_cluster_occupancy failed: cudaError {err}')
    return smem.value, threads.value, clusters.value


def _launch(gates_x: torch.Tensor, w_hh: torch.Tensor, mask: torch.Tensor,
            reverse: bool, design: tuple, peephole: Optional[torch.Tensor] = None,
            saved: Optional[tuple] = None) -> torch.Tensor:
    """Launches ``design`` of ``csrc/lstm.cu`` on checked CUDA tensors and
    counts the launch; raises if the launch is refused. The peephole
    weights go to the kernel as a float32 (D, 3, H) copy. `saved`, the
    training forward's (gates, c, h) float32 buffers, makes the kernel
    write them."""
    B, T, D, H = _shapes(gates_x, w_hh, mask, peephole)
    out = torch.empty((B, T, D, H), dtype=gates_x.dtype, device=gates_x.device)
    if B == 0 or T == 0:
        return out
    save_ptrs = [None] * 3 if saved is None else [t.data_ptr() for t in saved]
    from kraken_tpu_torch.ops.build import load_library
    lib = load_library('lstm')
    stream = torch.cuda.current_stream(gates_x.device).cuda_stream
    dev = gates_x.device.index
    peep = None if peephole is None else peephole.to(torch.float32).contiguous()
    peep_ptr = None if peep is None else peep.data_ptr()
    if design[0] == 'cluster':
        _, C, R = design
        fn = lib.lstm_recurrence_cluster
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(gates_x.data_ptr(), w_hh.data_ptr(), mask.data_ptr(), peep_ptr, out.data_ptr(),
                 *save_ptrs, B, T, D, H, C, R, int(bool(reverse)), DTYPE_CODES[gates_x.dtype],
                 DTYPE_CODES[w_hh.dtype], dev, stream)
    else:
        # the stream design reads w_hh transposed and in fp32
        w_hh_t = w_hh.to(torch.float32).transpose(1, 2).contiguous()
        fn = lib.lstm_recurrence_stream
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(gates_x.data_ptr(), w_hh_t.data_ptr(), mask.data_ptr(), peep_ptr,
                 out.data_ptr(), *save_ptrs, B, T, D, H, int(bool(reverse)),
                 DTYPE_CODES[gates_x.dtype], dev, stream)
    if err != 0:
        raise RuntimeError(f'lstm_recurrence {design[0]} kernel launch failed: cudaError {err}')
    lstm_recurrence.launches += 1
    lstm_recurrence.design_launches[design[0]] += 1
    if peep is not None:
        lstm_recurrence.peephole_launches += 1
    return out


def _launch_backward(dout: torch.Tensor, gates: torch.Tensor, cs: torch.Tensor,
                     w_hh: torch.Tensor, mask: torch.Tensor, reverse: bool,
                     peephole: Optional[torch.Tensor], design: tuple) -> torch.Tensor:
    """Launches ``design`` of the backward kernel of ``csrc/lstm.cu`` on the
    saving forward's buffers and counts the launch; raises if it is
    refused: (B, T, D, 4H) float32, the gradient of the gate
    pre-activations."""
    B, T, D, G = gates.shape
    H = G // 4
    dgates = torch.empty_like(gates)
    if B == 0 or T == 0:
        return dgates.zero_()
    from kraken_tpu_torch.ops.build import load_library
    lib = load_library('lstm')
    dev = gates.device.index
    stream = torch.cuda.current_stream(gates.device).cuda_stream
    w32 = w_hh.to(torch.float32).contiguous()
    peep = None if peephole is None else peephole.to(torch.float32).contiguous()
    args = (dout.data_ptr(), gates.data_ptr(), cs.data_ptr(), w32.data_ptr(), mask.data_ptr(),
            None if peep is None else peep.data_ptr(), dgates.data_ptr(), B, T, D, H)
    if design[0] == 'cluster':
        fn = lib.lstm_recurrence_backward_cluster
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(*args, design[1], design[2], int(bool(reverse)), dev, stream)
    else:
        fn = lib.lstm_recurrence_backward
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(*args, int(bool(reverse)), dev, stream)
    if err != 0:
        raise RuntimeError(f'lstm_recurrence backward {design[0]} kernel launch failed: '
                           f'cudaError {err}')
    lstm_recurrence.backward_launches += 1
    lstm_recurrence.backward_design_launches[design[0]] += 1
    if peep is not None:
        lstm_recurrence.backward_peephole_launches += 1
    return dgates


def _shift_carry(cs: torch.Tensor, reverse: bool) -> torch.Tensor:
    """The cell carry before each step from the carry after it (B, T, D,
    H): the carry of the step before in each direction's order, 0 at its
    first step."""
    D = cs.shape[2]
    before = torch.zeros_like(cs)
    for d in range(D):
        if (d == 1) != reverse:
            before[:, :-1, d] = cs[:, 1:, d]
        else:
            before[:, 1:, d] = cs[:, :-1, d]
    return before


class LSTMRecurrence(torch.autograd.Function):
    """
    :func:`lstm_recurrence` with a gradient, on CUDA tensors: the forward
    kernel in its saving mode (the activated gates, the cell carry after
    and the h carry before every step, float32), the backward kernel of
    ``csrc/lstm.cu`` for the gate gradients. What sums over all steps at
    once stays in torch: ``dW_hh[d] = Σ_{b,t} dgates ⊗ h_before`` and the
    peephole weights' gradients (``Σ dpre_i·c_before``, ``Σ dpre_f·c_before``,
    ``Σ dpre_o·c_after``). float32 only.
    """

    @staticmethod
    def forward(ctx, gates_x, w_hh, mask, reverse, peephole):
        B, T, D, H = _shapes(gates_x, w_hh, mask, peephole)
        f32 = dict(dtype=torch.float32, device=gates_x.device)
        saved = (torch.empty((B, T, D, 4 * H), **f32), torch.empty((B, T, D, H), **f32),
                 torch.empty((B, T, D, H), **f32))
        out = _launch(gates_x, w_hh, mask, reverse, _design(B, T, D, H), peephole, saved)
        ctx.reverse = reverse
        ctx.save_for_backward(w_hh, mask, peephole, *saved)
        return out

    @staticmethod
    def backward(ctx, dout):
        w_hh, mask, peephole, gates, cs, hs = ctx.saved_tensors
        B, T, D, G = gates.shape
        dgates = _launch_backward(dout.to(torch.float32).contiguous(), gates, cs, w_hh, mask,
                                  ctx.reverse, peephole, _backward_design(B, T, D, G // 4))
        d_w_hh = torch.einsum('btdg,btdh->dgh', dgates, hs) if ctx.needs_input_grad[1] else None
        d_peep = None
        if peephole is not None and ctx.needs_input_grad[4]:
            H = cs.shape[3]
            before = _shift_carry(cs, ctx.reverse)
            d_peep = torch.stack([(dgates[..., :H] * before).sum(dim=(0, 1)),
                                  (dgates[..., H:2 * H] * before).sum(dim=(0, 1)),
                                  (dgates[..., 3 * H:] * cs).sum(dim=(0, 1))], dim=1)
            d_peep = d_peep.to(peephole.dtype)
        return dgates, d_w_hh, None, None, d_peep


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
    float32 copy (D, H, 4H), made on each call. With grad mode on and an
    input that requires a gradient it runs :class:`LSTMRecurrence` (float32
    only: another type raises a TypeError).
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
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (gates_x, w_hh, peephole)):
        if any(t is not None and t.dtype != torch.float32 for t in (gates_x, w_hh, peephole)):
            raise TypeError('the recurrence\'s gradient is float32 only: training runs in '
                            'float32 whatever the precision')
        return LSTMRecurrence.apply(gates_x, w_hh, mask, bool(reverse), peephole)
    return _launch(gates_x, w_hh, mask, reverse, _design(B, T, D, H), peephole)


lstm_recurrence.launches = 0
lstm_recurrence.design_launches = {'cluster': 0, 'stream': 0}
lstm_recurrence.peephole_launches = 0
lstm_recurrence.backward_launches = 0
lstm_recurrence.backward_design_launches = {'cluster': 0, 'stream': 0}
lstm_recurrence.backward_peephole_launches = 0
