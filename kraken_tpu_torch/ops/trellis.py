"""
kraken_tpu_torch.ops.trellis
~~~~~~~~~~~~~~~~~~~~~~~~~~~~

The CTC forced-alignment trellis, batched over the lines of a page: the
port of the JAX package's ``align.py:get_trellis_device`` (a ``lax.scan``
over frames there), equal bit for bit to its numpy ``get_trellis``.

For line n with ``T_n`` frames, ``L_n >= 1`` tokens, emission ``E_n``
(T_n, C) of log-probabilities and tokens ``tok_n`` (L_n,):

- ``tr[0, 0] = 0`` and ``tr[0, 1:] = -inf``;
- ``tr[1:, 0]`` is the running sum of ``E[:, 0]``, summed frame by frame
  in fp32 as ``np.cumsum`` sums it, with its last ``L_n`` rows set to
  ``+inf``;
- ``tr[t+1, j] = max(tr[t, j] + E[t, 0], tr[t, j-1] + E[t, tok[j-1]])``.

The batch is padded: emission (N, T_max, C) float32, tokens (N, L_max)
int32, and each line's frame and token counts. The result (N, T_max + 1,
L_max + 1) holds line n's trellis in its top-left (T_n + 1, L_n + 1) block
(:func:`blocks` hands back those views); the rest is undefined.
:func:`pad` builds such a batch from each line's emission and tokens.

On a CUDA tensor :func:`trellis` launches the hand-written kernel of
``csrc/trellis.cu`` or raises; on a CPU tensor it runs
:func:`trellis_reference`, the plain PyTorch version.

The kernel is bound by the chain of T dependent rows, not by bytes or
operations. Its first design, a block a line (the "block" route), spent a
frame on a block barrier, a round trip through shared memory and a gather
of the next frame's emissions from device memory; the "warp" route, which
every page of lines up to 255 tokens takes, gives a line one warp, holds
the row in registers (lane l the columns l + 32 k, k < K) and passes each
column's left neighbour by a shuffle; the line's emission rows come
``CHUNK`` frames at a time, copied coalesced and asynchronously into
shared memory while the chunk before is computed, and each column reads
its token from the staged row. Lines of 256 to 2,047 tokens, and codecs
whose chunks exceed a block's shared memory (over 1,815 classes), keep
the block route; longer lines take the "long" route. :func:`plan` mirrors
in plain Python the launch the source takes (its route, from the page's
longest line and its classes) and :func:`geometry` asks the source
itself.
"""
import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from kraken_tpu_torch.ops.build import raw_stream

__all__ = ['trellis', 'trellis_reference', 'pad', 'blocks', 'plan', 'geometry', 'ROUTES']

# the kernel's routes (csrc/trellis.cu), in the order the source tries
# them, and their constants: a warp a line for up to 32 * WARP_MAX_K
# columns (up to WARP_LINES lines a block, each with two buffers of CHUNK
# emission rows in shared memory, of which an H100 block may have
# SMEM_OPTIN bytes); a block a line, a thread a column (COLS_PER_THREAD
# above MAX_THREADS columns), up to COLS_PER_THREAD * MAX_THREADS columns;
# the long kernel for any length
ROUTES = ('warp', 'block', 'long')
WARP_MAX_K = 8
WARP_LINES = 4
CHUNK = 16
MAX_THREADS = 1024
COLS_PER_THREAD = 2
SMEM_OPTIN = 232448


def chunk_floats(C: int) -> int:
    """A warp's chunk buffer on the warp route, in floats: CHUNK rows of C
    floats and 3 to align its first 16-byte copy, rounded up to 16 bytes."""
    return (CHUNK * C + 6) // 4 * 4


def _check(emission: torch.Tensor, tokens: torch.Tensor, frame_lens: torch.Tensor,
           token_lens: torch.Tensor) -> None:
    """Raises on shapes, types and devices the trellis does not take."""
    if emission.dim() != 3 or tokens.dim() != 2 or tokens.shape[0] != emission.shape[0] \
            or frame_lens.shape != (emission.shape[0],) or token_lens.shape != (emission.shape[0],):
        raise ValueError('trellis takes emission (N, T, C), tokens (N, L) and frame and '
                         f'token counts (N,); got {tuple(emission.shape)}, {tuple(tokens.shape)}, '
                         f'{tuple(frame_lens.shape)}, {tuple(token_lens.shape)}')
    if emission.dtype != torch.float32:
        raise TypeError(f'emission must be float32, not {emission.dtype}')
    for name, t in (('tokens', tokens), ('frame_lens', frame_lens), ('token_lens', token_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f'{name} must be int32, not {t.dtype}')
        if t.device != emission.device:
            raise ValueError(f'{name} lies on {t.device}, emission on {emission.device}')
    if emission.shape[2] < 1 or tokens.shape[1] < 1:
        raise ValueError('trellis needs at least one class and one token, got '
                         f'C={emission.shape[2]}, L={tokens.shape[1]}')


# what the kernel's error bits and :func:`_check_values` refuse
_REFUSED = {1: 'frame counts outside [0, T] or token counts outside [1, L]',
            2: 'tokens outside [0, C)', 4: 'emissions that are not finite'}


def _check_values(emission: torch.Tensor, tokens: torch.Tensor, frame_lens: torch.Tensor,
                  token_lens: torch.Tensor) -> None:
    """Raises on the values the kernel refuses (its error bits): counts out
    of range, tokens outside the classes, emissions the recurrence reads
    (the blank and the line's tokens at its frames) that are not finite
    (the trellis is defined for log-probabilities; np.maximum and a max by
    fmaxf would differ on NaN)."""
    N, T, C = emission.shape
    frames, lens = frame_lens.tolist(), token_lens.tolist()
    if not all(0 <= f <= T for f in frames) or not all(1 <= n <= tokens.shape[1] for n in lens):
        raise ValueError(f'trellis refuses {_REFUSED[1]}')
    line_tokens = [tokens[n, :L].to(torch.int64) for n, L in enumerate(lens)]
    if any(((t < 0) | (t >= C)).any() for t in line_tokens):
        raise ValueError(f'trellis refuses {_REFUSED[2]}')
    if not all(torch.isfinite(emission[n, :f, 0]).all()
               and torch.isfinite(emission[n, :f][:, t]).all()
               for n, (f, t) in enumerate(zip(frames, line_tokens))):
        raise ValueError(f'trellis refuses {_REFUSED[4]}')


def trellis_reference(emission: torch.Tensor, tokens: torch.Tensor,
                      frame_lens: torch.Tensor, token_lens: torch.Tensor) -> torch.Tensor:
    """
    Plain PyTorch version of :func:`trellis`: a loop over frames in
    fp32, all lines at once, in numpy's order of operations (column 0
    summed frame by frame), so each line's block equals the numpy
    ``get_trellis`` bit for bit.
    """
    N, T_max, C = emission.shape
    device = emission.device
    inf = torch.tensor(float('inf'), device=device)
    first_inf = (frame_lens.to(torch.int64) + 1 - token_lens.to(torch.int64))
    blank = emission[:, :, 0]
    tok_e = torch.gather(emission, 2,
                         tokens.to(torch.int64)[:, None, :].expand(N, T_max, tokens.shape[1]))
    out = torch.empty((N, T_max + 1, tokens.shape[1] + 1), dtype=torch.float32, device=device)
    row = torch.full((N, tokens.shape[1] + 1), float('-inf'), dtype=torch.float32, device=device)
    row[:, 0] = torch.where(first_inf <= 0, inf, 0.0)
    out[:, 0] = row
    acc = torch.zeros(N, dtype=torch.float32, device=device)
    for t in range(T_max):
        acc = acc + blank[:, t]
        new = torch.empty_like(row)
        new[:, 0] = torch.where(first_inf <= t + 1, inf, acc)
        new[:, 1:] = torch.maximum(row[:, 1:] + blank[:, t:t + 1], row[:, :-1] + tok_e[:, t])
        row = new
        out[:, t + 1] = row
    return out


def plan(N: int, L_max: int, C: int) -> tuple[str, int, int, int, int, int]:
    """
    The launch the kernel takes for N lines of up to L_max tokens over C
    classes on an H100, as ``csrc/trellis.cu`` computes it: (route, token
    columns a thread, threads a block, lines a block, dynamic shared memory
    bytes a block, blocks). On the "warp" route block b takes lines
    ``b * WARP_LINES`` to ``+ WARP_LINES``, a warp each, lane l the columns
    ``l + 32 k`` for k < K, K the smallest of 1, 2, 4 and 8 that covers the
    L_max + 1 columns, and each warp two buffers of :func:`chunk_floats`
    (up to WARP_LINES warps a block, as many as their buffers fit); on the
    "block" and "long" routes block n takes line n.
    """
    cols = L_max + 1
    warp_bytes = 2 * chunk_floats(C) * 4
    lines = min(WARP_LINES, SMEM_OPTIN // warp_bytes)
    if cols <= 32 * WARP_MAX_K and lines:
        k = 1
        while 32 * k < cols:
            k *= 2
        return 'warp', k, 32 * lines, lines, lines * warp_bytes, -(-N // lines)
    if cols <= COLS_PER_THREAD * MAX_THREADS:
        cpt = 2 if cols > MAX_THREADS else 1
        per = -(-cols // cpt)
        return 'block', cpt, -(-per // 32) * 32, 1, 2 * cols * 4, N
    return 'long', -(-cols // MAX_THREADS), MAX_THREADS, 1, 0, N


def geometry(N: int, L_max: int, C: int, device_index: int = 0
             ) -> tuple[str, int, int, int, int, int]:
    """:func:`plan` as the kernel source answers it on a card
    (``trellis_geometry``, which reads the card's shared memory a
    block)."""
    from kraken_tpu_torch.ops.build import load_library
    fn = load_library('trellis').trellis_geometry
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 6
    fn.restype = ctypes.c_int
    out = [ctypes.c_int() for _ in range(6)]
    if fn(N, L_max, C, device_index, *map(ctypes.byref, out)) != 0:
        raise ValueError(f'trellis_geometry refused N={N} L_max={L_max} C={C}')
    route, *rest = (v.value for v in out)
    return (ROUTES[route], *rest)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The kernel's C entry point, with its argument types (built at first use)."""
    from kraken_tpu_torch.ops.build import load_library
    fn = load_library('trellis').trellis_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def trellis(emission: torch.Tensor, tokens: torch.Tensor, frame_lens: torch.Tensor,
            token_lens: torch.Tensor) -> torch.Tensor:
    """
    The trellises of a padded batch of lines (arguments and result as
    :func:`trellis_reference`).

    On a CPU tensor this is the plain version. On a CUDA tensor it launches
    the kernel of ``csrc/trellis.cu`` on the current stream, on the route
    :func:`plan` gives, adds one to ``trellis.launches`` and to the route's
    count in ``trellis.route_launches`` and waits for it (the kernel checks
    each line's counts, tokens and emissions and reports what it refuses).
    It raises on a type, shape, layout or device the kernel does not take
    (contiguous tensors), on counts out of range, tokens outside the
    classes and emissions that are not finite (as the plain version's
    caller does on the CPU), and when the launch is refused. A line may
    have any number of tokens.
    """
    _check(emission, tokens, frame_lens, token_lens)
    device = emission.device
    if device.type == 'cpu':
        _check_values(emission, tokens, frame_lens, token_lens)
        return trellis_reference(emission, tokens, frame_lens, token_lens)
    if device.type != 'cuda':
        raise ValueError(f'trellis runs on cpu or cuda tensors, not {device}')
    if not all(t.is_contiguous() for t in (emission, tokens, frame_lens, token_lens)):
        raise ValueError('trellis takes contiguous tensors')
    N, T_max, C = emission.shape
    if N == 0:
        return torch.empty((0, T_max + 1, tokens.shape[1] + 1), dtype=torch.float32,
                           device=device)
    return _launch(emission, tokens, frame_lens, token_lens, plan(N, tokens.shape[1], C)[0])


def _launch(emission: torch.Tensor, tokens: torch.Tensor, frame_lens: torch.Tensor,
            token_lens: torch.Tensor, route: str) -> torch.Tensor:
    """One launch of the kernel on `route` for a batch :func:`trellis` has
    checked (N > 0, contiguous, on the card), counted and waited for; the
    source refuses a route that does not take the batch."""
    device = emission.device
    N, T_max, C = emission.shape
    L_max = tokens.shape[1]
    out = torch.empty((N, T_max + 1, L_max + 1), dtype=torch.float32, device=device)
    error = torch.zeros(1, dtype=torch.int32, device=device)
    err = _kernel()(emission.data_ptr(), tokens.data_ptr(), frame_lens.data_ptr(),
                    token_lens.data_ptr(), out.data_ptr(), error.data_ptr(), N, T_max, C, L_max,
                    ROUTES.index(route), device.index, raw_stream(device.index))
    if err != 0:
        raise RuntimeError(f'trellis kernel launch failed on the {route} route: cudaError {err}')
    trellis.launches += 1
    trellis.route_launches[route] += 1
    refused = int(error.item())
    if refused:
        raise ValueError('trellis refuses ' + ', '.join(v for k, v in _REFUSED.items()
                                                        if refused & k))
    return out


trellis.launches = 0
trellis.route_launches = dict.fromkeys(ROUTES, 0)


def pad(emissions: Sequence[np.ndarray], tokens: Sequence[np.ndarray],
        device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The arguments of :func:`trellis` on `device` for a batch of lines:
    each line's (frames, classes) emission and its tokens, zero-padded into
    emission (N, T_max, C_max) float32 and tokens (N, L_max) int32, with
    each line's frame and token counts."""
    frames = [e.shape[0] for e in emissions]
    lens = [len(t) for t in tokens]
    batch = np.zeros((len(emissions), max(frames), max(e.shape[1] for e in emissions)), np.float32)
    labels = np.zeros((len(emissions), max(lens)), np.int32)
    for n, (e, t) in enumerate(zip(emissions, tokens)):
        batch[n, :e.shape[0], :e.shape[1]] = e
        labels[n, :len(t)] = t
    return (torch.from_numpy(batch).to(device), torch.from_numpy(labels).to(device),
            torch.tensor(frames, dtype=torch.int32, device=device),
            torch.tensor(lens, dtype=torch.int32, device=device))


def blocks(out, frame_lens, token_lens) -> list:
    """Each line's trellis: views of the top-left (T_n + 1, L_n + 1) blocks
    of a batch's result (a tensor or its numpy copy)."""
    return [out[n, :int(T) + 1, :int(L) + 1]
            for n, (T, L) in enumerate(zip(frame_lens, token_lens))]
