"""
kraken_tpu_torch.ops.lstm
~~~~~~~~~~~~~~~~~~~~~~~~~

The LSTM recurrence: the port of the JAX package's only TPU kernel,
``kraken_tpu/ops/lstm.py:lstm_pallas``.

:func:`lstm_recurrence` runs the recurrence over precomputed input
projections. On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/lstm.cu`` (built by :mod:`kraken_tpu_torch.ops.build`) or raises; on
a CPU tensor it runs :func:`lstm_recurrence_reference`, the plain PyTorch
version of the same function. The input projection ``x @ w_ih^T + b`` is a
large matrix product and stays outside, in ``torch.matmul``, as the JAX
package keeps it outside its kernel.

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
"""
import ctypes

import torch

__all__ = ['lstm_recurrence', 'lstm_recurrence_reference']

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _shapes(gates_x: torch.Tensor, w_hh: torch.Tensor,
            mask: torch.Tensor) -> tuple[int, int, int, int]:
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
    return B, T, D, H


def lstm_recurrence_reference(gates_x: torch.Tensor, w_hh: torch.Tensor,
                              mask: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """
    Plain PyTorch version of :func:`lstm_recurrence`: a Python loop over
    the time axis, float32 carry and recurrent product.

    Args:
        gates_x: (B, T, D, 4H) input projections incl. biases.
        w_hh: (D, 4H, H) torch-convention recurrent weights.
        mask: (B, T) validity mask (nonzero = valid).
        reverse: direction 0 walks the time axis back to front; direction
            1 (if any) walks it the other way.

    Returns:
        (B, T, D, H) hidden states, zero at masked steps.
    """
    B, T, D, H = _shapes(gates_x, w_hh, mask)
    valid = (mask != 0)[:, :, None]
    out = torch.zeros((B, T, D, H), dtype=gates_x.dtype, device=gates_x.device)
    for d in range(D):
        w_t = w_hh[d].to(torch.float32).t()
        h = torch.zeros((B, H), dtype=torch.float32, device=gates_x.device)
        c = torch.zeros_like(h)
        steps = range(T - 1, -1, -1) if (d == 1) != reverse else range(T)
        for t in steps:
            gates = gates_x[:, t, d].to(torch.float32) + h @ w_t
            i, f, g, o = gates.chunk(4, dim=1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            m = valid[:, t]
            c = torch.where(m, c_new, c)
            h = torch.where(m, h_new, h)
            out[:, t, d] = torch.where(m, h_new, 0.0).to(gates_x.dtype)
    return out


def lstm_recurrence(gates_x: torch.Tensor, w_hh: torch.Tensor,
                    mask: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """
    The LSTM recurrence (same arguments and result as
    :func:`lstm_recurrence_reference`).

    On a CPU tensor this is the plain version. On a CUDA tensor it launches
    the kernel of ``csrc/lstm.cu`` on the current stream and adds one to
    ``lstm_recurrence.launches``; it raises on a type, shape, layout or
    device the kernel does not take and when the launch is refused. The
    kernel takes ``gates_x`` in float32, bfloat16 or float16 (contiguous),
    ``mask`` as contiguous bool; ``w_hh`` is handed to it as a transposed
    float32 copy (D, H, 4H), 4·D·H² floats, made here on each call.
    """
    if gates_x.device.type == 'cpu':
        return lstm_recurrence_reference(gates_x, w_hh, mask, reverse)
    if gates_x.device.type != 'cuda':
        raise ValueError(f'lstm_recurrence runs on cpu or cuda tensors, not {gates_x.device}')
    B, T, D, H = _shapes(gates_x, w_hh, mask)
    if gates_x.dtype not in _DTYPES:
        raise TypeError(f'gates_x must be float32, bfloat16 or float16, not {gates_x.dtype}')
    if mask.dtype != torch.bool:
        raise TypeError(f'mask must be bool, not {mask.dtype}')
    if not (gates_x.is_contiguous() and mask.is_contiguous()):
        raise ValueError('gates_x and mask must be contiguous')
    if w_hh.device != gates_x.device or mask.device != gates_x.device:
        raise ValueError('gates_x, w_hh and mask must lie on one device')
    if H > 1024:
        raise ValueError(f'the kernel takes a hidden size of at most 1024, not {H}')
    out = torch.empty((B, T, D, H), dtype=gates_x.dtype, device=gates_x.device)
    if B == 0 or T == 0:
        return out
    w_hh_t = w_hh.to(torch.float32).transpose(1, 2).contiguous()
    from kraken_tpu_torch.ops.build import load_library
    lib = load_library('lstm')
    fn = lib.lstm_recurrence
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(gates_x.device).cuda_stream
    err = fn(gates_x.data_ptr(), w_hh_t.data_ptr(), mask.data_ptr(), out.data_ptr(),
             B, T, D, H, int(bool(reverse)), _DTYPES[gates_x.dtype], gates_x.device.index,
             stream)
    if err != 0:
        raise RuntimeError(f'lstm_recurrence kernel launch failed: cudaError {err}')
    lstm_recurrence.launches += 1
    return out


lstm_recurrence.launches = 0
