"""
The packed gather (``csrc/extract.cu`` ``packed_gather_kernel``, the atlas
gather of ``input_transfer='packed'``) modelled in numpy, step for step.

The model follows the kernel's launch (``launch_gather``: runs a row, rows
a block, the grid of row groups by lines) and each thread's work: a run of
``kRunBytes / itemsize`` consecutive columns (8 fp32, 16 bf16 or fp16)
starting where the output row is 16-byte aligned, two 16-byte stores for a
whole run, scalar stores for a row's ragged head and tail; a run past the
line's width stores zeros without a load; a run inside the atlas loads the
aligned 32-bit words that hold its bytes and shifts them into place
(``__funnelshift_r``), masks the bytes past the width, any other run takes
the clamped index a byte. A byte's quotient is ``b * r`` with ``r`` 1/255 in
fp32, then one correction ``q + r (b - 255 q)`` by two FMAs, each rounded
once.

It must give:

- for all 256 bytes, the quotient :func:`dequantize` takes (an IEEE
  division by 255) in fp32, bf16 and fp16, held to exact rationals;
- every output column written exactly once, with no load of a word that
  holds no byte of its run, for line offsets of every residue mod 16,
  widths 0-17, batch-pad lines, clamped offsets, ``max_w`` on the width
  ladder and off it, and output rows that do and do not start 16-byte
  aligned;
- the plain version (``packed_gather_reference``) and the JAX package's
  ``fwd_packed`` gather bit for bit;

with the constants read back from the source.
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import importlib.util
import re
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kraken_tpu_torch.inference.recognition import width_bucket
from kraken_tpu_torch.ops.extract import dequantize, packed_gather, packed_gather_reference

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / 'kraken_tpu_torch' / 'csrc' / 'extract.cu'

RUN_BYTES = 32        # output bytes of a thread's run: two 16-byte stores
THREADS = 256         # threads a block
ITEMS = 1024          # runs a block aims at
MIN_BLOCKS = 264      # blocks a launch keeps while rows allow
INV255 = np.float32(1 / 255)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke', ROOT / 'chip_smoke.py')
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = _smoke()


def f32(x: Fraction) -> np.float32:
    """`x` rounded to the nearest fp32, ties to even."""
    f = np.float32(float(x))
    best = None
    for c in (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))):
        key = (abs(Fraction(float(c)) - x), int(np.array(c).view(np.int32)) & 1)
        if best is None or key < best[0]:
            best = (key, c)
    return np.float32(best[1])


def fma(a, b, c) -> np.float32:
    """``__fmaf_rn``: a * b + c exact, rounded once."""
    return f32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def quotient(b: int) -> np.float32:
    """The kernel's quotient of byte b: the byte as 2^23 + b minus 2^23,
    q = b * r, then q + r (b - 255 q), each step rounded once."""
    bf = np.float32(np.array(0x4B000000 | b, np.uint32).view(np.float32)) - np.float32(2 ** 23)
    q = f32(Fraction(float(bf)) * Fraction(float(INV255)))
    return fma(fma(-q, np.float32(255), bf), INV255, q)


QUOTIENTS = np.array([quotient(b) for b in range(256)], np.float32)


def test_the_quotients_are_ieee_divisions_in_every_type():
    assert all(Fraction(float(QUOTIENTS[b])) == Fraction(float(f32(Fraction(b, 255))))
               for b in range(256))
    byte = torch.arange(256, dtype=torch.uint8)
    for dtype in DTYPES:
        want = dequantize(byte, dtype)
        assert torch.equal(torch.from_numpy(QUOTIENTS).to(dtype).view(torch.int16 if dtype.itemsize
                                                                        == 2 else torch.int32),
                           want.view(torch.int16 if dtype.itemsize == 2 else torch.int32))
    # without the correction, the product is an ulp off on 126 bytes
    products = [f32(Fraction(b) * Fraction(float(INV255))) for b in range(256)]
    assert sum(p != q for p, q in zip(products, QUOTIENTS)) == 126


# ---------------------------------------------------------------- the model

def plan(n: int, rows: int, max_w: int, itemsize: int, out_addr: int) -> tuple[int, int, int]:
    """``launch_gather``: (columns a run, runs a row, rows a block)."""
    run = RUN_BYTES // itemsize
    aligned = out_addr % 16 == 0 and max_w * itemsize % 16 == 0
    runs = -(-max_w // run) + (0 if aligned else 1)
    rpb = max(1, min(rows, ITEMS // runs))
    while rpb > 1 and n * -(-rows // rpb) < MIN_BLOCKS:
        rpb //= 2
    return run, runs, rpb


def model(atlas: np.ndarray, aux: np.ndarray, max_w: int, dtype, atlas_addr: int = 0,
          out_addr: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's batch (as fp32 quotients) and how often each element
    was written, the atlas at byte address `atlas_addr` and the output at
    `out_addr` (the kernel sees only their residues mod 16)."""
    c, h, atlas_w = atlas.shape
    rows, n = c * h, aux.shape[1]
    itemsize = torch.empty((), dtype=dtype).element_size()
    run, runs, rpb = plan(n, rows, max_w, itemsize, out_addr)
    words = run // 4
    flat = atlas.reshape(-1)
    out = np.full((n, rows, max_w), np.nan, np.float32)
    writes = np.zeros((n, rows, max_w), np.int64)
    for i in range(n):                                   # blockIdx.y
        off, wid = int(aux[0, i]), int(aux[1, i])
        for row0 in range(0, rows, rpb):                 # blockIdx.x
            for t in range(min(rpb, rows - row0) * runs):
                row, j = row0 + t // runs, t % runs
                dst = out_addr + ((i * rows + row) * max_w) * itemsize
                head = (16 - dst % 16) % 16 // itemsize
                x0 = (head - run if head > 0 else 0) + j * run
                src = row * atlas_w
                whole = x0 >= 0 and x0 + run <= max_w
                if whole and x0 >= wid:
                    assert (dst + x0 * itemsize) % 16 == 0
                    writes[i, row, x0:x0 + run] += 1
                    out[i, row, x0:x0 + run] = 0.0
                    continue
                if whole:
                    valid, pos = min(run, wid - x0), off + x0
                    if pos >= 0 and pos + valid <= atlas_w:
                        assert (dst + x0 * itemsize) % 16 == 0
                        writes[i, row, x0:x0 + run] += 1
                        addr = atlas_addr + src + pos
                        s = addr % 4
                        base = addr - s - atlas_addr
                        raw = []
                        for m in range(words + 1):
                            if 4 * m < s + valid:
                                # the word holds a byte of the run, so none past the atlas
                                lo = base + 4 * m
                                assert lo + 3 >= src + pos and lo < src + pos + valid
                                got = [int(flat[k]) if 0 <= k < flat.size else 0
                                       for k in range(lo, lo + 4)]
                                raw.append(sum(v << (8 * q) for q, v in enumerate(got)))
                            else:
                                raw.append(0)
                        w = []
                        for m in range(words):
                            w.append(((raw[m] | raw[m + 1] << 32) >> (8 * s)) & 0xFFFFFFFF)
                            keep = valid - 4 * m
                            if keep < 4:
                                w[m] &= 0 if keep <= 0 else (1 << (8 * keep)) - 1
                        out[i, row, x0:x0 + run] = [QUOTIENTS[(w[k // 4] >> (8 * (k % 4))) & 255]
                                                    for k in range(run)]
                        continue
                # a ragged head or tail, or a clamped run: scalar stores
                for k in range(run):
                    x = x0 + k
                    if x < 0 or x >= max_w:
                        continue
                    writes[i, row, x] += 1
                    v = np.float32(0)
                    if x < wid:
                        v = QUOTIENTS[flat[src + min(max(off + x, 0), atlas_w - 1)]]
                    out[i, row, x] = v
    return out.reshape(n, c, h, max_w), writes


def jax_gather(atlas: np.ndarray, aux: np.ndarray, max_w: int, dtype) -> np.ndarray:
    """The gather of the JAX package's fwd_packed
    (kraken_tpu/inference/recognition.py:164-170), op by op."""
    off, wid = jnp.asarray(aux[0]), jnp.asarray(aux[1])
    xs = jnp.arange(max_w, dtype=jnp.int32)
    idx = jnp.clip(off[:, None] + xs[None, :], 0, atlas.shape[-1] - 1)
    batch = jnp.transpose(jnp.asarray(atlas)[:, :, idx], (2, 0, 1, 3))
    mask = xs[None, :] < wid[:, None]
    batch = jnp.where(mask[:, None, None, :], batch, 0)
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
              torch.float16: jnp.float16}[dtype]
    with jax.disable_jit():
        return np.asarray((batch.astype(jnp.float32) / 255.0).astype(jdtype).astype(jnp.float32))


# max_w on the ladder of the engine (width_bucket) and off it
def test_the_cases_cover_the_ladder_and_off_it():
    """chip_smoke.py's edge widths (the card's cases): on the ladder and
    off it."""
    widths = SMOKE.PACKED_EDGE_WIDTHS
    assert {128, 160} <= set(widths) and [w for w in widths if width_bucket(w) != w]
    assert SMOKE.EXTRACT_DTYPES == DTYPES


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('max_w', sorted({*SMOKE.PACKED_EDGE_WIDTHS, 23, 208}))
def test_model_covers_every_column_once_and_equals_the_plain_version_and_jax(max_w, dtype):
    atlas, aux = SMOKE.packed_edge_case(max_w, max_w)
    for atlas_addr in (0, 1, 2, 3):
        got, writes = model(atlas, aux, max_w, dtype, atlas_addr=atlas_addr)
        assert (writes == 1).all()
        plain = packed_gather_reference(torch.from_numpy(atlas), torch.from_numpy(aux), max_w,
                                        dtype)
        ours = torch.from_numpy(got).to(dtype)
        assert torch.equal(ours.view(torch.int16 if dtype.itemsize == 2 else torch.int32),
                           plain.view(torch.int16 if dtype.itemsize == 2 else torch.int32))
    np.testing.assert_array_equal(ours.float().numpy(), jax_gather(atlas, aux, max_w, dtype))


@pytest.mark.parametrize('out_addr', [4, 8, 12])
@pytest.mark.parametrize('max_w', [16, 21])
def test_rows_that_start_unaligned_take_scalar_heads(max_w, out_addr):
    """An output that starts off a 16-byte boundary (the kernel takes any
    pointer its type aligns): one more run a row, every column once."""
    atlas, aux = SMOKE.packed_edge_case(max_w, 3)
    got, writes = model(atlas, aux, max_w, torch.float32, out_addr=out_addr)
    assert (writes == 1).all()
    plain = packed_gather_reference(torch.from_numpy(atlas), torch.from_numpy(aux), max_w)
    assert np.array_equal(got.view(np.int32), plain.numpy().view(np.int32))


@pytest.mark.parametrize('n, rows, max_w, itemsize, want', [
    (16, 120, 1744, 4, (8, 218, 4)),       # the pipeline's widest batch, fp32
    (16, 120, 1744, 2, (16, 109, 4)),      # the same in bf16: 9 rows would leave 224 blocks
    (16, 30, 256, 4, (8, 32, 1)),          # 30 rows, then 15, 7, 3: under 264 blocks
    (1, 120, 256, 4, (8, 32, 1)),          # one line: a row a block
    (4, 48 * 3, 304, 2, (16, 19, 1)),
    (2, 1, 7, 4, (8, 2, 1))])              # off the ladder: a run more
def test_the_launch(n, rows, max_w, itemsize, want):
    assert plan(n, rows, max_w, itemsize, 0) == want


def test_widest_batch_blocks():
    """The pipeline's widest batch (16, 1, 120, 1744) fp32: 480 blocks of
    872 runs (3.4 a thread)."""
    run, runs, rpb = plan(16, 120, 1744, 4, 0)
    assert 16 * -(-120 // rpb) == 480 and rpb * runs == 872


def test_plan_constants_are_the_kernel_sources():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf'constexpr int {name} = (\d+);', src).group(1))

    assert const('kRunBytes') == RUN_BYTES
    assert const('kGatherThreads') == THREADS
    assert const('kGatherItems') == ITEMS
    assert const('kGatherMinBlocks') == MIN_BLOCKS
    inv = re.search(r'constexpr float kInv255 = (0x[0-9a-fp.\-]+)f;', src).group(1)
    assert np.float32(float.fromhex(inv)) == INV255 and float.fromhex(inv) == float(INV255)
    assert 'const int runs = (max_w + kRun - 1) / kRun + (aligned ? 0 : 1);' in src
    assert 'int rows_per_block = max(1, min(rows, kGatherItems / runs));' in src
    assert 'const bool whole = x0 >= 0 && x0 + kRun <= max_w;' in src
    assert ('const int x0 = (head > 0 ? head - kRun : 0) + j * kRun;' in src
            and '__byte_perm(word, 0x4B000000u, 0x7440u | k)' in src
            and 'return __fmaf_rn(__fmaf_rn(-q, 255.f, b), kInv255, q);' in src)


def test_the_wrapper_runs_the_plain_version_on_the_cpu():
    atlas, aux = SMOKE.packed_edge_case(40, 5)
    before = packed_gather.launches
    got = packed_gather(torch.from_numpy(atlas), torch.from_numpy(aux), 40, torch.bfloat16)
    assert packed_gather.launches == before
    assert torch.equal(got, packed_gather_reference(torch.from_numpy(atlas), torch.from_numpy(aux),
                                                    40, torch.bfloat16))
