"""
kraken_tpu_torch.ops.extract
~~~~~~~~~~~~~~~~~~~~~~~~~~~~

The two gathers that build a recognition batch on the device, the port of
the JAX package's XLA programs:

- :func:`extract_batch`, the gather-warp of device line extraction
  (``kraken_tpu/inference/extraction.py:486`` ``extract_batch_jnp``):
  rebuilds the padded (n, 1, H, max_w) batch from the page's bytes and
  each line's sampling grid and mask envelope;
- :func:`packed_gather`, the atlas gather of ``input_transfer='packed'``
  (``kraken_tpu/inference/recognition.py:158`` ``fwd_packed``): pads a
  dense width-concatenated byte atlas back to the (n, c, h, max_w) batch.

On a CUDA tensor each wrapper launches its hand-written kernel of
``csrc/extract.cu`` or raises; on a CPU tensor it runs its plain PyTorch
version (:func:`extract_batch_reference`, :func:`packed_gather_reference`).
The gather-warp reads the page and the batch's atlas where they lie, as
one buffer (``atlas=``): the plain version takes their concatenation.
Kernel and plain version round every step alike, so they agree bit for
bit: both take the IEEE quotient by 255 (and by the subsample count),
where torch divides a CUDA tensor by a Python number as a multiply by its
fp32 reciprocal (:func:`divide`); the gather-warp's kernel contracts no
product into an FMA, and the packed gather's takes the quotient of a byte
as a multiply by that reciprocal and one FMA correction, correctly
rounded for all 256 bytes (``tests/test_torch_packed_plan.py``).
"""
import ctypes
import functools
from typing import Optional

import torch

from kraken_tpu_torch.ops.build import DTYPE_CODES, raw_stream

__all__ = ['extract_batch', 'extract_batch_reference', 'extract_margins', 'window_routes',
           'packed_gather', 'packed_gather_reference', 'divide', 'dequantize', 'M_GRID', 'M_MASK',
           'MAX_SS', 'MAX_BYTES']

# warp-grid knot columns and mask-envelope knots a line (the JAX package's
# inference/extraction.py constants)
M_GRID = 129
M_MASK = 65
# the largest supersampling factor the kernel is built for
MAX_SS = 4
# the most bytes the gather-warp's buffer may hold (page and atlas together):
# the kernel addresses a line's bytes by 32-bit offsets
MAX_BYTES = 2 ** 31 - 1
# the widest and tallest strip the kernel's direct route takes
_MAX_SIDE = 1 << 22


def divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as an IEEE division on either device: torch divides a CUDA
    tensor by a Python number as a multiply by the fp32 reciprocal, which
    differs by an ulp on 126 of the 256 byte values over 255; a 0-d tensor
    divisor on the same device divides."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def dequantize(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A uint8 batch as values in [0, 1] in `dtype`: the 'uint8' input
    route's cast (torch ops), bit for bit the packed gather's."""
    return divide(x.float(), 255.0).to(dtype)


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``: max with `lo`, then min with `hi` (either may be a
    tensor)."""
    x = torch.maximum(x, lo) if isinstance(lo, torch.Tensor) else x.clamp(min=lo)
    return torch.minimum(x, hi) if isinstance(hi, torch.Tensor) else x.clamp(max=hi)


def _index(idx: torch.Tensor, last: int) -> torch.Tensor:
    """Buffer indices as jnp indexing takes them: a negative one counts from
    the end once (numpy's rule), then every one is clamped into the buffer
    (XLA's gather)."""
    return torch.where(idx < 0, idx + (last + 1), idx).clamp(0, last)


def _extract(buf, grid, mask, meta, max_w: int, height: int, ss: int, margins: bool):
    """The gather-warp in float32, and with `margins` the smallest distance
    a pixel's envelope tests and floors keep from their thresholds."""
    n = grid.shape[0]
    dev = buf.device
    meta = meta.long()
    off = meta[:, 0, None, None]
    w = meta[:, 1, None, None]
    h = meta[:, 2, None, None]
    W_l = meta[:, 3]
    padl = meta[:, 5]
    stride = meta[:, 6, None, None]
    ssf = meta[:, 7].float()
    c_rel = (torch.arange(max_w, device=dev)[None, :] - padl[:, None]).float()   # (n, max_w)
    stepg = (W_l.clamp(min=2) - 1).float() / (M_GRID - 1)
    stepm = (W_l.clamp(min=2) - 1).float() / (M_MASK - 1)
    buf_f = buf.float()
    last = buf.numel() - 1
    gflat = grid.reshape(n, M_GRID, 9)
    rows = torch.arange(height, device=dev, dtype=torch.float32)
    acc = torch.zeros((n, height, max_w), dtype=torch.float32, device=dev)
    margin = torch.full((n, height, max_w), float('inf'), device=dev) if margins else None

    def to_floor(v):
        return (v - torch.floor(v)).minimum(torch.ceil(v) - v) if margins else None

    for si in range(ss):
        for sj in range(ss):
            cf = c_rel + ssf[:, None] * ((si + 0.5) / ss - 0.5)                   # (n, max_w)
            rf = rows[None, :, None] + ssf[:, None, None] * ((sj + 0.5) / ss - 0.5)  # (n, H, 1)
            # column lerp of the 3 (x, y, row) knots
            g = cf / stepg[:, None]
            gi = _clip(torch.floor(g).long(), 0, M_GRID - 2)
            gf = _clip(g - gi, 0.0, 1.0)[:, :, None]
            p_lo = torch.gather(gflat, 1, gi[:, :, None].expand(n, max_w, 9))
            p_hi = torch.gather(gflat, 1, (gi + 1)[:, :, None].expand(n, max_w, 9))
            p = (p_lo + gf * (p_hi - p_lo)).reshape(n, max_w, 3, 3).permute(0, 2, 3, 1)
            r0 = p[:, 0, 2][:, None, :]                                          # (n, 1, max_w)
            r1 = p[:, 1, 2][:, None, :]
            r2 = p[:, 2, 2][:, None, :]
            t_up = _clip((rf - r0) / torch.clamp(r1 - r0, min=1e-3), 0.0, 1.0)
            t_lo = _clip((rf - r1) / torch.clamp(r2 - r1, min=1e-3), 0.0, 1.0)
            upper = rf < r1
            x = torch.where(upper,
                            p[:, 0, 0][:, None, :] + t_up * (p[:, 1, 0] - p[:, 0, 0])[:, None, :],
                            p[:, 1, 0][:, None, :] + t_lo * (p[:, 2, 0] - p[:, 1, 0])[:, None, :])
            y = torch.where(upper,
                            p[:, 0, 1][:, None, :] + t_up * (p[:, 1, 1] - p[:, 0, 1])[:, None, :],
                            p[:, 1, 1][:, None, :] + t_lo * (p[:, 2, 1] - p[:, 1, 1])[:, None, :])
            # bilinear sample of the flat buffer: strips address w x h at
            # stride w, page-resident lines the same window at the page's
            # row stride; indices as jnp indexing takes them (_index)
            x = _clip(x, 0.0, (w - 1).float())
            y = _clip(y, 0.0, (h - 1).float())
            ix = _clip(torch.floor(x).long(), 0, (w - 2).clamp(min=0))
            iy = _clip(torch.floor(y).long(), 0, (h - 2).clamp(min=0))
            fx = x - ix
            fy = y - iy
            base = off + iy * stride + ix
            ix1 = torch.minimum(ix + 1, w - 1) - ix
            iy1 = (torch.minimum(iy + 1, h - 1) - iy) * stride
            v00 = buf_f[_index(base, last)]
            v01 = buf_f[_index(base + ix1, last)]
            v10 = buf_f[_index(base + iy1, last)]
            v11 = buf_f[_index(base + iy1 + ix1, last)]
            val = ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
                   + (v10 * (1 - fx) + v11 * fx) * fy)
            # polygon envelope mask, with the host rasterizer's half pixel
            # of slack
            gm = cf / stepm[:, None]
            mi = _clip(torch.floor(gm).long(), 0, M_MASK - 2)
            mf = _clip(gm - mi, 0.0, 1.0)[:, :, None]
            m_lo = torch.gather(mask, 1, mi[:, :, None].expand(n, max_w, 2))
            m_hi = torch.gather(mask, 1, (mi + 1)[:, :, None].expand(n, max_w, 2))
            env = m_lo + mf * (m_hi - m_lo)                                       # (n, max_w, 2)
            top = env[:, None, :, 0] - 0.5
            bottom = env[:, None, :, 1] + 0.5
            valid = (rf >= top) & (rf <= bottom)
            acc = acc + torch.where(valid, val, 0.0)
            if margins:
                near = torch.stack(torch.broadcast_tensors(
                    (rf - top).abs(), (rf - bottom).abs(), (rf - r1).abs(), to_floor(g)[:, None, :],
                    to_floor(gm)[:, None, :], to_floor(x), to_floor(y)))
                margin = torch.minimum(margin, near.nan_to_num(0.0).amin(dim=0))
    out = divide(acc, float(ss * ss))
    col_valid = (c_rel >= 0) & (c_rel < W_l[:, None].float())
    # pad columns carry white (255) before inversion, masked-out pixels
    # black (0): after the inversion 0 and full scale, as the host tail
    out = torch.where(col_valid[:, None, :], divide(255.0 - out, 255.0), 0.0)
    return out[:, None], margin


def extract_batch_reference(buf: torch.Tensor, grid: torch.Tensor, mask: torch.Tensor,
                            meta: torch.Tensor, max_w: int, height: int, ss: int = 2,
                            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """
    Plain PyTorch version of :func:`extract_batch`, a transcription of the
    JAX package's ``extract_batch_jnp`` in its order of operations.

    Per output pixel and each of the ss x ss subsamples: column-lerp the
    three (x, y, row) knots of the bracketing grid columns, row-lerp
    piecewise about the middle knot, bilinear-sample the buffer, test the
    mask envelope; average the subsamples, paint the pad columns and invert
    the ink. A line whose ``meta[:, 7]`` is 0 samples every subsample at
    the pixel's centre.

    Args:
        buf: flat uint8 pixel buffer (the resident page, then the atlas of
             packed strips).
        grid: (n, M_GRID, 3, 3) float32 (x, y, row) knots.
        mask: (n, M_MASK, 2) float32 envelope rows.
        meta: (n, 8) int32: offset, w, h, W_l, seq_len, left pad, row
              stride, supersampling flag.
        max_w: the batch's width; height: the network's line height.
        ss: supersampling factor; dtype: the output type.

    Returns:
        (n, 1, height, max_w) values in [0, 1] in `dtype`.
    """
    return _extract(buf, grid, mask, meta, max_w, height, ss, False)[0].to(dtype)


def extract_margins(buf: torch.Tensor, grid: torch.Tensor, mask: torch.Tensor,
                    meta: torch.Tensor, max_w: int, height: int, ss: int = 2) -> torch.Tensor:
    """(n, 1, height, max_w) float32: the smallest distance, over a pixel's
    subsamples, of any envelope test or floor argument of the plain version
    from its threshold; where it is small, a rounding elsewhere may flip
    the pixel's test."""
    return _extract(buf, grid, mask, meta, max_w, height, ss, True)[1][:, None]


def packed_gather_reference(atlas: torch.Tensor, aux: torch.Tensor, max_w: int,
                            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """
    Plain PyTorch version of :func:`packed_gather` (the JAX package's
    ``fwd_packed`` gather): ``out[i, c, r, x] = atlas[c, r, off[i] + x] /
    255`` for ``x < wid[i]``, else 0, the index clamped into the atlas.

    Args:
        atlas: (c, h, atlas_w) uint8, the lines' columns side by side.
        aux: (3, n) int32 offsets, widths and sequence lengths.
        max_w: the batch's width; dtype: the output type.

    Returns:
        (n, c, h, max_w) in `dtype`.
    """
    off, wid = aux[0].long(), aux[1].long()
    xs = torch.arange(max_w, device=atlas.device)
    idx = (off[:, None] + xs[None, :]).clamp(0, atlas.shape[-1] - 1)
    batch = atlas[:, :, idx].permute(2, 0, 1, 3)
    keep = xs[None, :] < wid[:, None]
    batch = torch.where(keep[:, None, None, :], batch, torch.zeros((), dtype=torch.uint8,
                                                                   device=atlas.device))
    return dequantize(batch, dtype)


@functools.lru_cache(maxsize=None)
def _kernels():
    """The kernels' C entry points, with their argument types (built at
    first use)."""
    from kraken_tpu_torch.ops.build import load_library
    lib = load_library('extract')
    warp = lib.extract_forward
    warp.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    warp.restype = ctypes.c_int
    gather = lib.packed_gather_forward
    gather.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    gather.restype = ctypes.c_int
    return warp, gather


def _check_cuda(name: str, tensors: dict, device: torch.device) -> None:
    for key, (t, dtype) in tensors.items():
        if t.device != device:
            raise ValueError(f'{name}: {key} is on {t.device}, the buffer on {device}')
        if t.dtype != dtype:
            raise TypeError(f'{name}: {key} must be {dtype}, not {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: {key} must be contiguous')


def window_routes(meta, page_len: int, atlas_len: int) -> list:
    """How the gather-warp kernel reads each line of a batch (the test it
    makes once a thread, mirrored): 'page' or 'atlas' where the line's
    window, every byte its samples can read (``[off, off + (h - 1) stride
    + w - 1]``), lies inside that buffer (32-bit offsets from the window's
    first byte, no clamp), else 'clamped' (the plain version's indices
    into the two buffers taken as one, as jnp indexing takes them); 'pad'
    for a row of no column (W_l 0: zeros, no sample). `meta` is the (n, 8)
    int32 array of :func:`extract_batch_reference`."""
    routes = []
    for off, w, h, W_l, _, _, stride, _ in (tuple(int(v) for v in row) for row in meta):
        if W_l <= 0:
            routes.append('pad')
            continue
        hi = off + (h - 1) * stride + w - 1
        direct = 2 <= w <= _MAX_SIDE and 2 <= h <= _MAX_SIDE and stride >= 0
        if direct and 0 <= off and hi < page_len:
            routes.append('page')
        elif direct and page_len <= off and hi < page_len + atlas_len:
            routes.append('atlas')
        else:
            routes.append('clamped')
    return routes


def extract_batch(buf: torch.Tensor, grid: torch.Tensor, mask: torch.Tensor,
                  meta: torch.Tensor, max_w: int, height: int, ss: int = 2,
                  dtype: torch.dtype = torch.float32,
                  atlas: Optional[torch.Tensor] = None) -> torch.Tensor:
    """
    The gather-warp of device line extraction (arguments and result of
    :func:`extract_batch_reference`).

    With `atlas`, `buf` is the page and the batch's packed strips follow in
    `atlas`: meta's offsets address the two as one buffer, an offset at or
    past ``len(buf)`` reading the atlas, and the batch equals the plain
    version's on ``torch.cat([buf, atlas])``. Either may be empty, not
    both; together they hold at most MAX_BYTES.

    On CPU tensors this is the plain version (on the concatenation). On
    CUDA tensors it launches the kernel of ``csrc/extract.cu`` on the
    current stream, which reads both buffers where they lie, writing the
    batch in `dtype` (float32, bfloat16 or float16), and adds one to
    ``extract_batch.launches``; it raises on a device, type, shape or
    layout the kernel does not take and when the launch is refused.
    """
    n = grid.shape[0]
    if grid.shape != (n, M_GRID, 3, 3) or mask.shape != (n, M_MASK, 2) \
            or meta.shape != (n, 8) or buf.dim() != 1 or (atlas is not None and atlas.dim() != 1):
        raise ValueError(f'extract_batch: grid {tuple(grid.shape)}, mask {tuple(mask.shape)}, '
                         f'meta {tuple(meta.shape)}, buf {tuple(buf.shape)}, atlas '
                         f'{None if atlas is None else tuple(atlas.shape)} do not fit '
                         f'(n, {M_GRID}, 3, 3), (n, {M_MASK}, 2), (n, 8), (len,), (len,)')
    if not 1 <= ss <= MAX_SS or max_w < 1 or height < 1:
        raise ValueError(f'extract_batch: ss {ss} (1 to {MAX_SS}), max_w {max_w} and height '
                         f'{height} must be positive')
    page_len, atlas_len = buf.numel(), 0 if atlas is None else atlas.numel()
    if page_len + atlas_len == 0:
        raise ValueError('extract_batch: the pixel buffer is empty')
    if page_len + atlas_len > MAX_BYTES:
        raise ValueError(f'extract_batch: the pixel buffer holds {page_len + atlas_len} bytes, '
                         f'more than the {MAX_BYTES} the kernel addresses with 32-bit offsets')
    device = buf.device
    if device.type == 'cpu':
        whole = buf if atlas is None else torch.cat([buf, atlas])
        return extract_batch_reference(whole, grid, mask, meta, max_w, height, ss, dtype)
    if device.type != 'cuda':
        raise ValueError(f'extract_batch runs on cpu or cuda tensors, not {device}')
    code = DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f'extract_batch writes float32, bfloat16 or float16, not {dtype}')
    tensors = {'buf': (buf, torch.uint8), 'grid': (grid, torch.float32),
               'mask': (mask, torch.float32), 'meta': (meta, torch.int32)}
    if atlas is not None:
        tensors['atlas'] = (atlas, torch.uint8)
    _check_cuda('extract_batch', tensors, device)
    out = torch.empty((n, 1, height, max_w), dtype=dtype, device=device)
    if n == 0:
        return out
    err = _kernels()[0](buf.data_ptr() if page_len else None,
                        atlas.data_ptr() if atlas_len else None, grid.data_ptr(),
                        mask.data_ptr(), meta.data_ptr(), out.data_ptr(), page_len, atlas_len, n,
                        height, max_w, ss, code, device.index, raw_stream(device.index))
    if err != 0:
        raise RuntimeError(f'extract_batch kernel launch failed: cudaError {err}')
    extract_batch.launches += 1
    return out


extract_batch.launches = 0


def packed_gather(atlas: torch.Tensor, aux: torch.Tensor, max_w: int,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """
    The atlas gather of ``input_transfer='packed'`` (arguments and result
    of :func:`packed_gather_reference`).

    On CPU tensors this is the plain version. On CUDA tensors it launches
    the kernel of ``csrc/extract.cu`` on the current stream and adds one to
    ``packed_gather.launches``; it raises on a device, type, shape or
    layout the kernel does not take and when the launch is refused.
    """
    if atlas.dim() != 3 or aux.dim() != 2 or aux.shape[0] != 3 or max_w < 1:
        raise ValueError(f'packed_gather: atlas {tuple(atlas.shape)} must be (c, h, atlas_w), '
                         f'aux {tuple(aux.shape)} (3, n), max_w {max_w} positive')
    device = atlas.device
    if device.type == 'cpu':
        return packed_gather_reference(atlas, aux, max_w, dtype)
    if device.type != 'cuda':
        raise ValueError(f'packed_gather runs on cpu or cuda tensors, not {device}')
    code = DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f'packed_gather writes float32, bfloat16 or float16, not {dtype}')
    _check_cuda('packed_gather', {'atlas': (atlas, torch.uint8), 'aux': (aux, torch.int32)},
                device)
    c, h, atlas_w = atlas.shape
    n = aux.shape[1]
    if atlas_w == 0:
        raise ValueError('packed_gather: the atlas is empty')
    out = torch.empty((n, c, h, max_w), dtype=dtype, device=device)
    if out.numel() == 0:
        return out
    err = _kernels()[1](atlas.data_ptr(), aux.data_ptr(), out.data_ptr(), n, c, h, atlas_w,
                        max_w, code, device.index, raw_stream(device.index))
    if err != 0:
        raise RuntimeError(f'packed_gather kernel launch failed: cudaError {err}')
    packed_gather.launches += 1
    return out


packed_gather.launches = 0
