"""
kraken_tpu_torch.ops.seam
~~~~~~~~~~~~~~~~~~~~~~~~~

Batched minimum-energy seam carving for line polygonization
(``seam_carver='device'``), the port of the JAX package's ``ops/seam.py``.

The polygonizer carves one seam per side of each baseline through an
energy patch. :func:`carve_seams_ragged` takes a page's raw patches as they
are (each its own (h, w)), packs them column-major with their two +inf pad
rows into one buffer (:func:`pack_patches`; pinned for the card), and
:func:`seam_carve` uploads it in one copy, runs the forward DP, the start
selection and the backtrace of every patch in one launch of the kernel of
``csrc/seam.cu`` and downloads the seam rows, ``sum(widths)`` int32 values
with the pad offset removed, in one copy. Nothing is padded to a common
shape: the JAX package's ``carve_seams_device`` (``kraken_tpu/ops/seam.py:
51-89``) pads the page to one (N, H, W) batch and selects and walks on the
host. Where no cost overflows, the rows equal that function's on the padded
batch and the native host DP's (``native.carve_seam_native``).

:func:`carve_seams_device` keeps the JAX signature (a padded batch is a
ragged batch whose heights are all H) and :func:`seam_forward` the padded
batch's backtrack and cost column (the kernel's forward mode).

On CUDA tensors the wrappers launch the kernel or raise; on the CPU they
run the plain versions, :func:`seam_carve_reference` (numpy) and
:func:`seam_forward_reference` (torch), which the kernel equals bit for
bit in rows and codes (its costs by value: the sign of a zero may differ,
which no comparison sees).
"""
import ctypes
import dataclasses
import functools
import threading

import numpy as np
import torch

from kraken_tpu_torch.ops.build import raw_stream

__all__ = ['carve_seams_ragged', 'carve_seams_device', 'pack_patches', 'check_packed',
           'seam_carve', 'seam_carve_reference', 'seam_forward', 'seam_forward_reference',
           'group_plan', 'lane_rows', 'geometry', 'Packed', 'BIG', 'GROUP_ROWS']

# the sentinel of the DP's borders and of the +inf pad (np.nan_to_num's posinf)
BIG = 3.4e38

# the launch's constants (``csrc/seam.cu``; ``geometry`` asks the source):
# warps a block, column tiles a warp keeps in flight, the group route's
# tallest patch, the bytes ahead of a warp's tiles, the block route's
# energy columns in flight at most
WARPS, STAGES, GROUP_ROWS, REGION_HEAD, RING = 4, 3, 1920, 64, 16
# the group route's plan: one warp up to SOLO_ROWS rows a lane, else as many
# warps as keep a lane at GROUP_LANE_ROWS rows (on the card, a column of one
# warp costs about 80 + 28 (R - 1) cycles; a group's warps trade edges
# behind a barrier, which 3 warps of 5 rows a lane repay above 224 rows)
SOLO_ROWS, GROUP_LANE_ROWS = 7, 5
# a column tile (words) and a warp's shared backtrack (bytes)
STAGE_FLOATS, CODE_SLOT = 2048, 30720
# a block's dynamic shared memory, and so the tallest patch the block route
# takes (its mbarriers, two cost and two energy columns)
SMEM_BYTES = WARPS * (-(-(REGION_HEAD + 4 * STAGES * STAGE_FLOATS + CODE_SLOT) // 128) * 128)
BLOCK_ROWS = (SMEM_BYTES - 8 * RING) // 16 // 4 * 4
DESC_WORDS = 8
_INT32 = 2 ** 31 - 1

_COUNT_LOCK = threading.Lock()


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def lane_rows(height: int, warps: int) -> int:
    """Rows a lane holds on the group route, as the kernel reads them from
    a patch's height and its warps: the least odd count that covers the
    height."""
    return -(-height // (32 * warps)) | 1


def group_plan(height: int):
    """(warps, rows a lane) of the group route for a patch of `height`
    rows (its pad rows included): one warp while a lane holds SOLO_ROWS
    rows or fewer, else as many warps as keep a lane at GROUP_LANE_ROWS
    (at most WARPS), then as few as hold the patch at the rows a lane that
    gives; None above GROUP_ROWS (the block route)."""
    if height > GROUP_ROWS:
        return None
    if height <= 32 * SOLO_ROWS:
        return 1, lane_rows(height, 1)
    g = min(WARPS, -(-height // (32 * GROUP_LANE_ROWS)))
    g = -(-height // (32 * lane_rows(height, g)))
    return g, lane_rows(height, g)


def _code_bytes(height: int, width: int, warps: int) -> int:
    """Backtrack bytes a warp of the group route keeps: a word of 2 bits a
    row (1, 2 or 4 bytes) a lane and column after the first, rounded up to
    16."""
    r = lane_rows(height, warps)
    return _round16((width - 1) * 32 * (1 if r <= 3 else 2 if r <= 7 else 4))


def _layout(h: np.ndarray, w: np.ndarray, warp_rows: int) -> tuple:
    """The launch of patches of heights `h` and widths `w`: (slots, n_block)
    with slots a list of (patch, warps, rank) or None (an idle warp):
    first the block route's patches (taller than `warp_rows` or than the
    group route takes), one a block; then blocks of WARPS warps, each
    patch's group of warps consecutive in one block, the longest first
    (columns times rows a lane)."""
    plans = [group_plan(int(a)) if a <= warp_rows else None for a in h]
    slots = [(k, 1, 0) for k in range(len(h)) if plans[k] is None]
    n_block = len(slots)
    groups = sorted((k for k in range(len(h)) if plans[k] is not None),
                    key=lambda k: (-(w[k] - 1) * plans[k][1], -plans[k][0], k))
    blocks = []
    for k in groups:
        g = plans[k][0]
        block = next((b for b in blocks if len(b) + g <= WARPS), None)
        if block is None:
            blocks.append(block := [])
        block.extend((k, g, r) for r in range(g))
    for block in blocks:
        slots += block + [None] * (WARPS - len(block))
    return slots, n_block


@dataclasses.dataclass
class Packed:
    """A batch of patches packed for the kernel (:func:`pack_patches`):
    `buffer`, float32: `n_slots` descriptors of 8 int32 words (data offset
    in words, height with the pad rows, width, first output row, backtrack
    offset in bytes or -1 for shared memory, index in the batch, 1 where
    the patch holds a value that is not finite (the kernel maps only those
    patches' energies), its group: warps | rank << 4, 0 for an idle warp),
    the first `n_block` one a block-route patch each (the tallest
    `max_block_height` rows), then WARPS a block of the group route; then
    each patch column-major with a column stride of its height rounded up
    to 4. `widths` and `out` (each patch's first output row) in batch
    order; `code_bytes` of backtrack in global memory."""
    buffer: torch.Tensor
    n_slots: int
    n_block: int
    max_block_height: int
    widths: np.ndarray
    out: np.ndarray
    code_bytes: int

    @property
    def n(self) -> int:
        return len(self.widths)

    @property
    def total(self) -> int:
        return int(self.widths.sum())

    def descriptors(self) -> np.ndarray:
        """The (n_slots, 8) int32 descriptors (a view of a host buffer)."""
        return self.buffer.numpy()[:DESC_WORDS * self.n_slots].view(np.int32).reshape(
            self.n_slots, DESC_WORDS)


def _descriptors(h, w, out, mapped, slots, n_block, code_base=None, cols=None) -> tuple:
    """The (n_slots, 8) descriptors of a layout, the data offset of each
    patch (after the descriptors, in slot order; `cols` columns each,
    default its width), the buffer's length in words and the backtrack
    bytes in global memory. With `code_base` (the forward mode) every slot
    of patch k writes its codes at ``code_base[k]``."""
    cols = w if cols is None else cols
    stride = (h + 3) // 4 * 4
    data = np.zeros(len(h), np.int64)
    at = DESC_WORDS * len(slots)
    code_bytes = 0
    desc = np.zeros((len(slots), DESC_WORDS), np.int64)
    for i, slot in enumerate(slots):
        if slot is None:
            continue
        k, g, rank = slot
        if rank == 0:
            data[k] = at
            at += int(cols[k] * stride[k])
        if code_base is not None:
            code = code_base[k]
        elif i < n_block:
            code, code_bytes = code_bytes, code_bytes + _round16(int((w[k] - 1) * h[k]))
        else:
            need = _code_bytes(int(h[k]), int(w[k]), g)
            code = -1
            if need > CODE_SLOT:
                code, code_bytes = code_bytes, code_bytes + need
        desc[i] = (data[k], h[k], w[k], out[k], code, k, mapped[k],
                   0 if i < n_block else g | rank << 4)
    return desc, data, at, code_bytes


def pack_patches(patches, pad_rows: bool = True, pin: bool = False,
                 warp_rows: int = GROUP_ROWS) -> Packed:
    """
    Packs 2-D energy patches for :func:`seam_carve`.

    Args:
        patches: (h, w) arrays, w >= 1; h >= 1 with `pad_rows` (each gets
                 an +inf row above and below, as the polygonizer pads
                 them), else h >= 3 (rows 0 and h - 1 are the pad rows).
        pad_rows: whether to add the pad rows.
        pin: pack into page-locked memory (for one asynchronous upload).
        warp_rows: the tallest padded patch the group route takes (the
                   others take the block route; 0 sends every patch there).

    Returns:
        a :class:`Packed` (:func:`_layout`'s launch).
    """
    n = len(patches)
    if n == 0:
        raise ValueError('pack_patches: no patch')
    shapes = np.array([np.shape(p) for p in patches], dtype=np.int64)
    if shapes.shape != (n, 2):
        raise ValueError(f'pack_patches: every patch must be 2-D, not {[np.shape(p) for p in patches]}')
    h = shapes[:, 0] + (2 if pad_rows else 0)
    w = shapes[:, 1]
    if (h < 3).any() or (w < 1).any():
        raise ValueError(f'pack_patches: a patch must have a row besides its pad rows and a '
                         f'column, not {shapes[(h < 3) | (w < 1)].tolist()}')
    out = np.concatenate([[0], np.cumsum(w)[:-1]]).astype(np.int64)
    mapped = np.array([not np.isfinite(p).all() for p in patches], np.int64)
    slots, n_block = _layout(h, w, warp_rows)
    desc, data, length, code_bytes = _descriptors(h, w, out, mapped, slots, n_block)
    if max(length, out[-1] + w[-1], code_bytes) > _INT32:
        raise ValueError(f'pack_patches: {length} words, {code_bytes} backtrack bytes: more '
                         'than the 32-bit offsets address')
    buffer = torch.empty(length, dtype=torch.float32, pin_memory=pin)
    words = buffer.numpy()
    words[:desc.size].view(np.int32)[:] = desc.ravel()
    stride = (h + 3) // 4 * 4
    for k, p in enumerate(patches):
        cols = words[data[k]:data[k] + w[k] * stride[k]].reshape(w[k], stride[k])
        if pad_rows:  # the +inf pad rows as the kernel maps them
            cols[:, 0] = cols[:, h[k] - 1] = BIG
            cols[:, 1:h[k] - 1] = np.asarray(p).T
        else:
            cols[:, :h[k]] = np.asarray(p).T
    tallest = max((int(h[slots[i][0]]) for i in range(n_block)), default=0)
    return Packed(buffer, len(slots), n_block, tallest, w.astype(np.int32), out, code_bytes)


def check_packed(packed: Packed) -> np.ndarray:
    """
    The descriptors of `packed` (host), each checked before a launch:
    raises ValueError where one would read or write outside its buffers, or
    where a patch is missing, repeated or on a route or group that cannot
    hold it.
    """
    buf = packed.buffer
    n, n_slots, n_block = packed.n, packed.n_slots, packed.n_block
    if buf.device.type != 'cpu' or buf.dtype != torch.float32 or buf.dim() != 1 \
            or not buf.is_contiguous():
        raise ValueError('seam_carve: the packed buffer must be a contiguous float32 host vector')
    if not 0 < n_slots <= buf.numel() // DESC_WORDS or not 0 <= n_block <= n_slots \
            or (n_slots - n_block) % WARPS or n == 0 or packed.out.shape != (n,) \
            or buf.numel() > _INT32 or not 0 <= packed.max_block_height <= BLOCK_ROWS \
            or not np.array_equal(packed.out, np.concatenate([[0], np.cumsum(packed.widths)[:-1]])):
        raise ValueError(f'seam_carve: {n_slots} descriptor slots ({n_block} on the block route) '
                         f'for {n} patches do not fit a buffer of {buf.numel()} words')
    desc = packed.descriptors().astype(np.int64)
    data, h, w, out, code, index, mapped, group = desc.T
    g, rank = group & 15, group >> 4
    slot = np.arange(n_slots)
    block = slot < n_block
    idle = ~block & (g == 0)
    used = ~idle
    stride = (h + 3) // 4 * 4
    warp = (slot - n_block) % WARPS
    bad = used & ((h < 3) | (w < 1) | (data < DESC_WORDS * n_slots) | (data % 4 != 0)
                  | (data + w * stride > buf.numel()) | (index < 0) | (index >= n)
                  | (mapped < 0) | (mapped > 1))
    bad |= block & ((h > packed.max_block_height) | (group != 0))
    bad |= ~block & used & ((g > WARPS) | (rank >= g) | (warp < rank)
                            | (warp - rank + g > WARPS) | (h > GROUP_ROWS))
    if not bad.any():
        rw = 32 * np.array([lane_rows(int(a), int(b)) if b else 1 for a, b in zip(h, g)])
        bad |= ~block & used & ((g * rw < h) | ((g - 1) * rw >= h) | (rw > 32 * 15))
        need = np.where(block, (w - 1) * h,
                        [_code_bytes(int(a), int(b), int(c)) if c else 0 for a, b, c in zip(h, w, g)])
        bad |= used & np.where(code < 0, block | (need > CODE_SLOT),
                               (code % 16 != 0) | (code + need > packed.code_bytes))
        # a group's warps: one patch, ranks in order, codes one stride apart
        lead = np.where(used & ~block, slot - rank, slot)
        want = desc[lead, :7].copy()
        want[:, 4] = np.where(code[lead] < 0, -1, code[lead] + rank * (-(-need[lead] // 16) * 16))
        bad |= ~block & used & ((desc[:, :7] != want).any(1) | (group[lead] != g))
    if not bad.any():
        first = used & (rank == 0)
        counts = np.bincount(index[first], minlength=n)
        if counts.shape != (n,) or (counts != 1).any():
            bad |= first
        else:
            bad |= first & ((w != packed.widths[index]) | (out != packed.out[index]))
    if bad.any() or (n_block and packed.max_block_height != h[:n_block].max()):
        raise ValueError(f'seam_carve: malformed descriptors at slots {np.flatnonzero(bad).tolist()}'
                         f' of {n_slots} (block route {n_block}, tallest {packed.max_block_height})')
    return desc


def _finite(x: np.ndarray) -> np.ndarray:
    return np.nan_to_num(x, posinf=BIG)


def seam_carve_reference(packed: Packed) -> np.ndarray:
    """
    Plain version of :func:`seam_carve` (numpy, on the host): the seam rows
    of every patch of `packed`, ``packed.total`` int32 values in batch
    order with the pad offset removed, then one status word a patch (1
    where the backtrace left its patch, as the kernel writes it).

    Per patch: the DP over the nan_to_num'd energies of its own H rows (the
    borders 3.4e38), the start at the first minimum over rows 1 .. H - 2,
    the backtrace counting a negative row once from the patch's end; a
    patch one column wide starts at np.argmin of its raw column 0.
    """
    desc = check_packed(packed)
    words = packed.buffer.numpy()
    n = packed.n
    first = desc[(np.arange(packed.n_slots) < packed.n_block) | (desc[:, 7] & 15 > 0)
                 & (desc[:, 7] >> 4 == 0)]
    data, h, w, out = first[np.argsort(first[:, 5])][:, :4].T
    stride = (h + 3) // 4 * 4
    raw = [words[data[s]:data[s] + w[s] * stride[s]].reshape(w[s], stride[s])[:, :h[s]].T
           for s in range(n)]
    rows = np.zeros(packed.total + n, np.int32)
    status = rows[packed.total:]
    seams = np.zeros((n, int(w.max())), np.int64)
    wide = np.flatnonzero(w > 1)
    for s in np.flatnonzero(w == 1):
        seams[s, 0] = np.argmin(raw[s][1:h[s] - 1, 0]) + 1
    if len(wide):
        hm, wm = int(h[wide].max()), int(w[wide].max())
        energy = np.full((len(wide), hm, wm), BIG, np.float32)
        for i, s in enumerate(wide):
            energy[i, :h[s], :w[s]] = _finite(raw[s])
        valid = np.arange(hm)[None, :] < h[wide][:, None]
        last = w[wide] - 1
        big = np.full((len(wide), 1), BIG, np.float32)
        cost = energy[:, :, 0].copy()
        back = np.zeros((len(wide), wm, hm), np.int8)
        with np.errstate(over='ignore'):
            for j in range(1, wm):
                up, down = np.concatenate([big, cost[:, :-1]], 1), np.concatenate([cost[:, 1:], big], 1)
                best, arg = up, np.zeros(cost.shape, np.int8)
                take = cost < best
                best, arg = np.where(take, cost, best), np.where(take, 1, arg)
                take = down < best
                best, arg = np.where(take, down, best), np.where(take, 2, arg)
                new = np.where(valid, energy[:, :, j] + best, np.float32(BIG))
                cost = np.where((j <= last)[:, None], new, cost)
                back[:, j] = arg
        hw, cur = h[wide], np.zeros(len(wide), np.int64)
        for i, s in enumerate(wide):
            cur[i] = np.argmin(cost[i, 1:hw[i] - 1]) + 1
        seams[wide, last] = cur
        alive = np.ones(len(wide), bool)
        for j in range(wm - 1, 0, -1):
            step = alive & (j <= last)
            idx = np.where(cur < 0, cur + hw, cur)
            off = (idx < 0) | (idx >= hw)
            status[wide[step & off]] = 1
            alive &= ~(step & off)
            step &= ~off
            cur = np.where(step, cur + back[np.arange(len(wide)), j, np.clip(idx, 0, hm - 1)] - 1,
                           cur)
            seams[wide[step], j - 1] = cur[step]
    for s in range(n):
        rows[out[s]:out[s] + w[s]] = seams[s, :w[s]] - 1
    return rows


@functools.lru_cache(maxsize=None)
def _kernels():
    """The kernel's C entry points, with their argument types (built at
    first use): (carve, forward)."""
    from kraken_tpu_torch.ops.build import load_library
    lib = load_library('seam')
    carve, forward = lib.seam_carve, lib.seam_forward
    carve.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    forward.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    carve.restype = forward.restype = ctypes.c_int
    return carve, forward


def geometry() -> tuple[int, int, int, int, int]:
    """(WARPS, STAGES, GROUP_ROWS, REGION_HEAD, RING) as the kernel source
    has them (``seam_geometry``)."""
    from kraken_tpu_torch.ops.build import load_library
    fn = load_library('seam').seam_geometry
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 5)()
    fn(out)
    return tuple(out)


def _launch(buf: torch.Tensor, packed: Packed, out: torch.Tensor, codes: torch.Tensor) -> None:
    """The carve's launch on the current stream: `buf` the packed buffer on
    the card, `out` int32 (total + n) rows and status words, `codes` the
    global backtrack (``packed.code_bytes``)."""
    dev = buf.device
    err = _kernels()[0](buf.data_ptr(), out.data_ptr(), out[packed.total:].data_ptr(),
                        codes.data_ptr(), packed.n_slots, packed.n_block, packed.max_block_height,
                        STAGE_FLOATS, CODE_SLOT, dev.index, raw_stream(dev.index))
    if err != 0:
        raise RuntimeError(f'seam_carve kernel launch failed: cudaError {err}')
    with _COUNT_LOCK:
        seam_carve.launches += 1


def seam_carve(packed: Packed, device='cuda') -> np.ndarray:
    """
    The seam rows of a packed batch (:func:`pack_patches`): ``packed.total``
    int32 values in batch order, each patch's rows with the pad offset
    removed.

    On ``device='cpu'`` this is the plain version. On a CUDA device it
    uploads the buffer in one copy, launches the kernel of ``csrc/seam.cu``
    once on the current stream (adding one to ``seam_carve.launches``),
    downloads the rows and the status words in one copy and waits for
    them. It raises ValueError on a malformed descriptor, before any
    launch, and IndexError where a backtrace leaves its patch (where numpy
    indexing raises on the host).
    """
    dev = torch.device(device)
    if dev.type == 'cpu':
        rows = seam_carve_reference(packed)
    elif dev.type == 'cuda':
        check_packed(packed)
        if dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
        with torch.cuda.device(dev):
            buf = packed.buffer.to(dev, non_blocking=True)
            out = torch.empty(packed.total + packed.n, dtype=torch.int32, device=dev)
            codes = torch.empty(max(packed.code_bytes, 16), dtype=torch.uint8, device=dev)
            _launch(buf, packed, out, codes)
            host = torch.empty(out.shape, dtype=torch.int32, pin_memory=True)
            host.copy_(out, non_blocking=True)
            torch.cuda.current_stream(dev).synchronize()
            rows = host.numpy().copy()
    else:
        raise ValueError(f'seam_carve runs on cpu or cuda, not {dev}')
    if rows[packed.total:].any():
        raise IndexError(f'a seam backtrace left its patch (launch slots '
                         f'{np.flatnonzero(rows[packed.total:]).tolist()})')
    return rows[:packed.total]


seam_carve.launches = 0


def carve_seams_ragged(patches, device='cuda') -> list:
    """
    The seam rows of each of a list of raw (h, w) energy patches, as the
    polygonizer carves them (an +inf pad row above and below each; rows
    returned with the pad offset removed): one upload, one launch and one
    download on a CUDA `device` (:func:`seam_carve`), the plain version on
    ``'cpu'``.
    """
    if not len(patches):
        return []
    dev = torch.device(device)
    packed = pack_patches(patches, pin=dev.type == 'cuda')
    rows = seam_carve(packed, dev)
    return np.split(rows, packed.out[1:])


def carve_seams_device(patches: np.ndarray, widths=None, device='cuda') -> np.ndarray:
    """
    Batched minimum-energy seams.

    Args:
        patches: (N, H, W) float32 energy patches, +inf padded to the
                 common shape (rows 0 and H-1 are pad rows).
        widths: per-patch valid widths (defaults to W); the backtrace starts
                at each patch's true last column so width padding cannot
                perturb the path.
        device: the torch device of the carve (``'cpu'`` runs its plain
                version).

    Returns:
        (N, W) int32 row index per column (valid through each patch's
        width, 0 past it). Each patch is carved over its own width and all
        H rows (:func:`seam_carve`). Where every patch is one column wide
        there is no DP (the JAX package fails on such a batch).
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
    dev = torch.device(device)
    packed = pack_patches([arr[k, :, :widths[k]] for k in range(n)], pad_rows=False,
                          pin=dev.type == 'cuda')
    rows = seam_carve(packed, dev) + 1
    seams[np.arange(w)[None, :] < widths[:, None]] = rows
    return seams


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
    last = (widths.long() - 1).clamp(min=1, max=W - 1).to(dev)
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


def seam_forward(patches: torch.Tensor, widths: torch.Tensor) -> tuple:
    """
    The forward seam DP of a padded batch (arguments and result of
    :func:`seam_forward_reference`).

    On CPU tensors this is the plain version. On CUDA tensors it lays the
    batch out column-major (torch ops on the card), and launches the
    forward mode of the kernel of ``csrc/seam.cu`` on the current stream
    (each patch run to its own last column, max(widths - 1, 1)), adding one
    to ``seam_forward.launches``; it raises on a type, shape, layout or
    device the kernel does not take and when the launch is refused.
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
    stride = (H + 3) // 4 * 4
    if H > BLOCK_ROWS or DESC_WORDS * 4 * N + N * W * stride > _INT32 or N * (W - 1) * H > _INT32:
        raise ValueError(f'seam_forward: patches {tuple(patches.shape)} outgrow the kernel')
    k = np.arange(N)
    h = np.full(N, H, np.int64)
    w = np.maximum(widths.cpu().numpy().astype(np.int64), 2)
    slots, n_block = _layout(h, w, GROUP_ROWS)
    desc, data, _, _ = _descriptors(h, w, np.zeros(N, np.int64), np.zeros(N, np.int64), slots,
                                    n_block, code_base=k * (W - 1) * H, cols=np.full(N, W))
    # each patch's W columns from its data offset (the widths only end the DP)
    cols = torch.full((W * stride * N,), BIG, dtype=torch.float32, device=device)
    order = torch.from_numpy(np.argsort(data)).to(device)
    cols.view(N, W, stride)[:, :, :H] = patches.transpose(1, 2)[order]
    buf = torch.cat([torch.from_numpy(desc.astype(np.int32)).view(torch.float32).flatten().to(
        device), cols])
    back = torch.empty((N, W - 1, H), dtype=torch.int8, device=device)
    col = torch.empty((N, H), dtype=torch.float32, device=device)
    err = _kernels()[1](buf.data_ptr(), back.data_ptr(), col.data_ptr(), len(slots), n_block,
                        H if n_block else 0, STAGE_FLOATS, CODE_SLOT, device.index,
                        raw_stream(device.index))
    if err != 0:
        raise RuntimeError(f'seam_forward kernel launch failed: cudaError {err}')
    with _COUNT_LOCK:
        seam_forward.launches += 1
    return back, col


seam_forward.launches = 0
