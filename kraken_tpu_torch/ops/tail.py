"""
kraken_tpu_torch.ops.tail
~~~~~~~~~~~~~~~~~~~~~~~~~

The tail of the recognition forward: a temperature softmax over the
classes, then the per-frame argmax and max. The port of ``_tail`` in the
JAX package's ``inference/recognition.py:prepare_recognition`` (jitted into
its forward there).

On a CUDA tensor :func:`recognition_tail` launches the hand-written kernel
of ``csrc/tail.cu`` or raises; on a CPU tensor it runs
:func:`recognition_tail_reference`, the plain PyTorch version. The kernel
writes the full (N, C, W) posteriors only when they are asked for; the
greedy decoder needs the (N, W) labels and confidences alone.

:func:`plan` mirrors in plain Python the launch the kernel takes (a tile
of F frames a block, a warp a frame; or, for codecs too large for an
8-frame tile in shared memory, the direct route); :func:`geometry` asks the
kernel source itself.
"""
import ctypes
import functools
import math
from typing import Optional

import torch

from kraken_tpu_torch.ops.build import DTYPE_CODES, raw_stream

__all__ = ['recognition_tail', 'recognition_tail_reference', 'plan', 'geometry', 'MAX_TILE_C']

# the kernel's launch (csrc/tail.cu): blocks of WARPS warps; a "tile" block
# takes F of FRAMES consecutive frames of a line and shared memory for them
# as fp32 with the row stride C rounded up to odd, F the largest that leaves
# room for two blocks an SM (233,472 bytes an SM on an H100, 1 KB reserved
# for each block); a "direct" block takes WARPS frames, a warp each
WARPS = 16
THREADS = 32 * WARPS
FRAMES = (32, 16, 8)
SMEM_TWO_BLOCKS = 233472 // 2 - 1024
# the largest C an 8-frame tile takes: 8 * (C | 1) * 4 <= SMEM_TWO_BLOCKS
MAX_TILE_C = 3615


def recognition_tail_reference(logits: torch.Tensor, temperature: float
                               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """
    Plain PyTorch version of :func:`recognition_tail`.

    The softmax is written out: ``exp(x / T - max)`` in fp32 over its sum,
    which is taken in fp64 and rounded to fp32 once. ``torch.softmax`` sums
    in fp32 and lands up to 1.6e-6 from the exact posteriors at 250
    classes; this one within an ulp or two, as the kernel does, so the two
    agree to 1e-6 whatever order either sums in.

    Args:
        logits: (N, C, 1, W) network output in any float type.
        temperature: the softmax temperature.

    Returns:
        (probs, labels, confs): (N, C, W) float32 posteriors, (N, W) int64
        first maximal classes, (N, W) float32 maxima.
    """
    v = logits.to(torch.float32) / temperature
    e = torch.exp(v - v.amax(dim=1, keepdim=True))
    probs = (e / e.sum(dim=1, keepdim=True, dtype=torch.float64).to(torch.float32)).squeeze(2)
    return probs, probs.argmax(dim=1), probs.amax(dim=1)


def plan(N: int, C: int, W: int) -> tuple[str, int, int, int, int]:
    """
    The launch the kernel takes for (N, C, 1, W) logits of any type, as
    ``csrc/tail.cu`` computes it: (route, frames a block, threads a block,
    dynamic shared memory bytes a block, blocks). On the "tile" route block
    b takes frames ``(b % tiles) * F`` to ``+ F`` of line ``b // tiles``,
    ``tiles = ceil(W / F)``; on the "direct" route block b takes the
    flattened frames ``b * WARPS`` to ``+ WARPS`` (frame ``n * W + w``).
    """
    cp = C | 1
    for f in FRAMES:
        if f * cp * 4 <= SMEM_TWO_BLOCKS:
            return 'tile', f, THREADS, f * cp * 4, N * -(-W // f)
    return 'direct', WARPS, THREADS, 0, -(-(N * W) // WARPS)


def geometry(N: int, C: int, W: int) -> tuple[str, int, int, int, int]:
    """:func:`plan` as the kernel source answers it (``tail_geometry``).
    Builds the kernel library; needs no card."""
    from kraken_tpu_torch.ops.build import load_library
    fn = load_library('tail').tail_geometry
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 4 \
        + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = [ctypes.c_int() for _ in range(4)] + [ctypes.c_longlong()]
    if fn(N, C, W, *map(ctypes.byref, out)) != 0:
        raise ValueError(f'tail_geometry refused N={N} C={C} W={W}')
    route, frames, threads, smem, blocks = (v.value for v in out)
    return ('tile', 'direct')[route], frames, threads, smem, blocks


@functools.lru_cache(maxsize=None)
def _kernel():
    """The kernel's C entry point, with its argument types (built at first use)."""
    from kraken_tpu_torch.ops.build import load_library
    fn = load_library('tail').tail_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3 \
        + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def recognition_tail(logits: torch.Tensor, temperature: float, probs: bool = True
                     ) -> tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """
    Temperature softmax, argmax and max over the classes (the arguments and
    results of :func:`recognition_tail_reference`; the posteriors are None
    unless `probs` is set).

    On a CPU tensor this is the plain version. On a CUDA tensor it launches
    the kernel of ``csrc/tail.cu`` on the current stream and adds one to
    ``recognition_tail.launches``; it raises on a type, shape, layout or
    device the kernel does not take ((N, C, 1, W) logits in float32,
    bfloat16 or float16, in any layout), on a zero or non-finite
    temperature, and when the launch is refused. The posteriors come back
    contiguous.
    """
    if logits.dim() != 4 or logits.shape[2] != 1:
        raise ValueError(f'logits must be (N, C, 1, W), got {tuple(logits.shape)}')
    device = logits.device
    if device.type == 'cpu':
        p, labels, confs = recognition_tail_reference(logits, temperature)
        return (p if probs else None), labels, confs
    if device.type != 'cuda':
        raise ValueError(f'recognition_tail runs on cpu or cuda tensors, not {device}')
    code = DTYPE_CODES.get(logits.dtype)
    if code is None:
        raise TypeError(f'logits must be float32, bfloat16 or float16, not {logits.dtype}')
    if temperature == 0 or not math.isfinite(temperature):
        raise ValueError(f'the temperature must be finite and non-zero, not {temperature}')
    N, C, _, W = logits.shape
    if C == 0:
        raise ValueError('logits have no classes')
    p = torch.empty((N, C, W), dtype=torch.float32, device=device) if probs else None
    labels = torch.empty((N, W), dtype=torch.int64, device=device)
    confs = torch.empty((N, W), dtype=torch.float32, device=device)
    if labels.numel() == 0:
        return p, labels, confs
    sn, sc, _, sw = logits.stride()
    err = _kernel()(logits.data_ptr(), p.data_ptr() if probs else None, labels.data_ptr(),
                    confs.data_ptr(), N, C, W, sn, sc, sw, temperature, code, device.index,
                    raw_stream(device.index))
    if err != 0:
        raise RuntimeError(f'recognition_tail kernel launch failed: cudaError {err}')
    recognition_tail.launches += 1
    return p, labels, confs


recognition_tail.launches = 0
