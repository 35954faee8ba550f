"""
kraken_tpu_torch.ops.seam
~~~~~~~~~~~~~~~~~~~~~~~~~

Batched minimum-energy seam carving for line polygonization
(``seam_carver='device'``), the port of the JAX package's ``ops/seam.py``.

The polygonizer carves one seam per side of each baseline through an
energy patch. :func:`carve_seams_device` takes a page's patches, padded to
a common (H, W) with +inf (rows 0 and H-1 of each patch are +inf pad rows),
runs the forward DP of every patch in one launch (:func:`seam_forward`)
and does the start selection and the backtrace on the host, exactly as the
JAX package's ``carve_seams_device`` (``kraken_tpu/ops/seam.py:51-89``).
Its rows equal the native host DP's (``native.carve_seam_native``).

On a CUDA tensor :func:`seam_forward` launches the hand-written kernel of
``csrc/seam.cu`` or raises; on a CPU tensor it runs
:func:`seam_forward_reference`, the plain PyTorch version, which the kernel
equals bit for bit on every column it writes.
"""
import ctypes
import functools
import threading

import numpy as np
import torch

from kraken_tpu_torch.ops.build import raw_stream

__all__ = ['seam_forward', 'seam_forward_reference', 'carve_seams_device', 'BIG']

# the sentinel of the DP's borders and of the +inf pad (np.nan_to_num's posinf)
BIG = 3.4e38

_COUNT_LOCK = threading.Lock()


def _last_columns(widths: torch.Tensor, W: int) -> torch.Tensor:
    """The last column each patch's DP runs to: max(widths - 1, 1)."""
    return (widths.long() - 1).clamp(min=1, max=W - 1)


def seam_forward_reference(patches: torch.Tensor, widths: torch.Tensor) -> tuple:
    """
    Plain PyTorch version of :func:`seam_forward`.

    Args:
        patches: (N, H, W) float32 energies, W >= 2 (+inf replaced by
                 :data:`BIG`).
        widths: (N,) int32 valid widths, 1 to W.

    Returns:
        (back, col): the (N, W-1, H) int8 backtrack (0 up, 1 stay, 2 down:
        the first minimum in that order; every column is written here, the
        kernel leaves those past a patch's last column unwritten) and the
        (N, H) float32 cost after column max(widths - 1, 1).
    """
    N, H, W = patches.shape
    dev = patches.device
    big = torch.full((N, 1), BIG, dtype=torch.float32, device=dev)
    last = _last_columns(widths, W).to(dev)
    cost = patches[:, :, 0].clone()
    back = torch.empty((N, W - 1, H), dtype=torch.int8, device=dev)
    col = torch.empty((N, H), dtype=torch.float32, device=dev)
    for j in range(1, W):
        up = torch.cat([big, cost[:, :-1]], 1)
        down = torch.cat([cost[:, 1:], big], 1)
        best, arg = up, torch.zeros((N, H), dtype=torch.int8, device=dev)
        take = cost < best
        best, arg = torch.where(take, cost, best), torch.where(take, 1, arg).to(torch.int8)
        take = down < best
        best, arg = torch.where(take, down, best), torch.where(take, 2, arg).to(torch.int8)
        cost = patches[:, :, j] + best
        back[:, j - 1] = arg
        done = last == j
        col[done] = cost[done]
    return back, col


@functools.lru_cache(maxsize=None)
def _kernel():
    """The kernel's C entry point, with its argument types (built at first use)."""
    from kraken_tpu_torch.ops.build import load_library
    fn = load_library('seam').seam_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def seam_forward(patches: torch.Tensor, widths: torch.Tensor) -> tuple:
    """
    The forward seam DP of a batch of patches (arguments and result of
    :func:`seam_forward_reference`).

    On CPU tensors this is the plain version. On CUDA tensors it launches
    the kernel of ``csrc/seam.cu`` on the current stream (one block a
    patch, each run to its own last column) and adds one to
    ``seam_forward.launches``; it raises on a type, shape, layout or device
    the kernel does not take and when the launch is refused.
    """
    if patches.dim() != 3 or widths.shape != (patches.shape[0],) or patches.shape[2] < 2 \
            or min(patches.shape) < 1:
        raise ValueError(f'seam_forward: patches {tuple(patches.shape)} must be (N, H, W) with '
                         f'W >= 2, widths {tuple(widths.shape)} (N,)')
    device = patches.device
    if widths.device != device:
        raise ValueError(f'seam_forward: widths are on {widths.device}, patches on {device}')
    if device.type == 'cpu':
        return seam_forward_reference(patches, widths)
    if device.type != 'cuda':
        raise ValueError(f'seam_forward runs on cpu or cuda tensors, not {device}')
    for key, t, dtype in (('patches', patches, torch.float32), ('widths', widths, torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f'seam_forward: {key} must be {dtype}, not {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'seam_forward: {key} must be contiguous')
    N, H, W = patches.shape
    back = torch.empty((N, W - 1, H), dtype=torch.int8, device=device)
    col = torch.empty((N, H), dtype=torch.float32, device=device)
    err = _kernel()(patches.data_ptr(), widths.data_ptr(), back.data_ptr(), col.data_ptr(),
                    N, H, W, device.index, raw_stream(device.index))
    if err != 0:
        raise RuntimeError(f'seam_forward kernel launch failed: cudaError {err}')
    with _COUNT_LOCK:
        seam_forward.launches += 1
    return back, col


seam_forward.launches = 0


def carve_seams_device(patches: np.ndarray, widths=None, device='cuda') -> np.ndarray:
    """
    Batched minimum-energy seams.

    Args:
        patches: (N, H, W) float32 energy patches, +inf padded to the
                 common shape (rows 0 and H-1 are pad rows).
        widths: per-patch valid widths (defaults to W); the backtrace starts
                at each patch's true last column so width padding cannot
                perturb the path.
        device: the torch device of the forward DP (``'cpu'`` runs its
                plain version).

    Returns:
        (N, W) int32 row index per column (valid through each patch's
        width). Where every patch is one column wide the DP has nothing to
        do (the JAX package fails on such a batch).
    """
    arr = np.asarray(patches, np.float32)
    n, h, w = arr.shape
    if widths is None:
        widths = np.full(n, w, np.int32)
    widths = np.asarray(widths, np.int32)
    if widths.shape != (n,) or (widths < 1).any() or (widths > w).any():
        raise ValueError(f'widths {widths} must be one per patch, 1 to {w}')
    seams = np.zeros((n, w), np.int32)
    if n == 0:
        return seams
    idx = np.arange(n)
    back = None
    if w > 1:
        dev = torch.device(device)
        x = torch.from_numpy(np.nan_to_num(arr, posinf=BIG)).to(dev)
        back_t, col_t = seam_forward(x, torch.from_numpy(widths).to(dev))
        back, col = back_t.cpu().numpy(), col_t.cpu().numpy()   # (N, W-1, H), (N, H)
        # each patch starts at its true last column. Rows 0 and H-1 are the
        # +inf pad rows, excluded from the start selection like the host DP
        # (it matters only when a patch's entire last column is masked)
        seams[idx, widths - 1] = np.argmin(col[:, 1:h - 1], axis=1) + 1
    if (widths == 1).any():
        # width-1 patches degenerate to an argmin of the raw energy
        seams[widths == 1, 0] = np.argmin(arr[widths == 1, 1:h - 1, 0], axis=1) + 1
    # host backtrace: an O(N * W) loop over the int8 offsets
    for j in range(w - 2, -1, -1):
        active = j + 1 <= widths - 1
        cur = seams[:, j + 1]
        off = back[idx, j, cur]
        seams[:, j] = np.where(active, cur + off.astype(np.int32) - 1, seams[:, j])
    return seams
