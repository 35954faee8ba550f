"""
The plain versions of the port's three segmentation kernels against the
JAX functions they port, on the same numpy-seeded inputs (fp32):

- the padding-aware GroupNorm against ``GroupNorm.apply`` (atol 1e-6 with
  rtol 1e-6: the outputs reach ~7, where one fp32 ulp is 4.8e-7, and the
  two sides take the statistics in fp32 in different orders; JAX sums in
  sequence, so the groups stay at a few hundred elements);
- the upsample+sigmoid head against ``jax.image.resize`` + ``sigmoid``
  (atol 1e-6), at integer and non-integer ratios;
- the Sato ridge filter against ``ops/ridge._sato_core_batch`` (atol 1e-5,
  the tolerance of the JAX package's own ridge tests), with masks equal
  except at pixels within 1e-5 of the threshold;
- the ridge kernel's launch as ``ops/ridge.plan`` mirrors it: shared memory
  for two blocks an SM, tiles that cover every pixel once, conflict-free
  shared loads; its multiply-adds a pixel, the least instructions its bound
  counts, and the versions ``chip_smoke.py --ridge-variants`` makes of it.

The CUDA kernels themselves run in tests/test_torch_cuda.py (GPU only).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kraken_tpu.nn.layers import GroupNorm as JaxGroupNorm
from kraken_tpu.ops import ridge as jax_ridge
from kraken_tpu_torch.ops import groupnorm, ridge, seghead

REPO = Path(__file__).resolve().parent.parent


def _groupnorm_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    # post-ReLU-like activations: mean about as large as the spread
    x = np.maximum(rng.randn(*shape), 0).astype(np.float32)
    w = (1 + 0.1 * rng.randn(shape[1])).astype(np.float32)
    b = (0.1 * rng.randn(shape[1])).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize('shape, groups, lens', [
    ((1, 16, 6, 17), 8, None),
    ((2, 8, 5, 31), 4, None),
    ((3, 16, 5, 31), 16, [31, 12, 1]),
    ((2, 12, 4, 40), 6, [7, 40]),
    ((2, 8, 4, 6), 2, [0, 9]),  # lengths outside [1, W] are clamped
])
def test_groupnorm_plain_matches_jax(shape, groups, lens):
    x, w, b = _groupnorm_inputs(shape, sum(shape))
    layer = JaxGroupNorm(shape[1], groups)
    params = {'layer.weight': jnp.asarray(w), 'layer.bias': jnp.asarray(b)}
    seq = None if lens is None else np.asarray(lens, np.int32)
    want, _ = layer.apply(params, jnp.asarray(x), None if seq is None else jnp.asarray(seq))
    got = groupnorm.group_norm_reference(torch.from_numpy(x), torch.from_numpy(w),
                                         torch.from_numpy(b), groups, 1e-5,
                                         None if seq is None else torch.from_numpy(seq))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    if seq is not None:
        for n, L in enumerate(np.clip(seq, 1, shape[3])):
            assert not got[n, :, :, L:].any()
    # the wrapper takes the plain version for a CPU tensor
    again = groupnorm.group_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                 groups, 1e-5, None if seq is None else torch.from_numpy(seq))
    assert torch.equal(again, got)


@pytest.mark.parametrize('groups, rows', [(8, 1024), (32, 1800), (16, 512), (1, 3), (2, 16)])
def test_groupnorm_blocks_cover_every_row(groups, rows):
    """The split the kernel is launched with: no empty block, every row."""
    S = groupnorm.blocks_per_group(groups, rows)
    per = -(-rows // S)
    assert S >= 1 and (S - 1) * per < rows <= S * per


# the GroupNorm inputs of the shipped model's page and of the full-size spec
SHIPPED_GN = [((1, 32, 256, 177), 8), ((1, 64, 128, 89), 16), ((1, 96, 128, 89), 16)]
FULL_GN = [((1, 64, 900, 623), 32), ((1, 128, 450, 312), 32), ((1, 256, 450, 312), 32)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape, groups', SHIPPED_GN)
def test_groupnorm_design_shipped_shapes_take_cluster(shape, groups, dtype):
    """Every GroupNorm of the shipped model runs as one cluster launch."""
    design = groupnorm._design(*shape, groups, dtype)
    assert design[0] == 'cluster' and design[1] in groupnorm.CLUSTER_SIZES


@pytest.mark.parametrize('shape, groups', [FULL_GN[0], FULL_GN[2]])
def test_groupnorm_design_large_groups_take_stream(shape, groups):
    """Groups of 4.5 MB in fp32 fit no cluster: the two-launch design."""
    assert groupnorm._design(*shape, groups, torch.float32) == ('stream',)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize('shape, groups', SHIPPED_GN + FULL_GN + [
    ((3, 16, 37, 61), 4), ((2, 8, 4, 6), 2), ((1, 4, 1, 5), 4), ((2, 12, 3, 1000), 3)])
def test_groupnorm_cluster_rows_fit_and_cover_the_group(shape, groups, dtype):
    """A CTA of the cluster design holds its rows within the 227 KB a block
    may take, and the CTAs' rows cover every row of the group exactly once."""
    N, C, H, W = shape
    design = groupnorm._design(N, C, H, W, groups, dtype)
    if design[0] == 'stream':
        return
    _, CL, R = design
    rows = (C // groups) * H
    assert 1 <= CL <= min(16, rows)
    assert groupnorm._cluster_smem(R, W, dtype) <= groupnorm.SMEM_PER_CTA < 232448
    taken = [r for rank in range(CL) for r in groupnorm._cta_rows(rows, CL, rank)]
    assert taken == list(range(rows))
    assert max(len(groupnorm._cta_rows(rows, CL, rank)) for rank in range(CL)) == R


@pytest.mark.parametrize('shape, out', [
    ((1, 10, 16, 11), (64, 44)),     # integer ratio 4
    ((2, 3, 13, 9), (50, 31)),       # non-integer ratios
    ((1, 2, 7, 7), (7, 20)),         # one axis unchanged
])
def test_seg_head_plain_matches_jax(shape, out):
    x = (np.random.RandomState(shape[2]).randn(*shape) * 3).astype(np.float32)
    want = jax.nn.sigmoid(jax.image.resize(jnp.asarray(x), shape[:2] + out, method='bilinear'))
    got = seghead.seg_head_reference(torch.from_numpy(x), *out)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:2] + out
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert torch.equal(seghead.seg_head(torch.from_numpy(x), *out), got)


@pytest.mark.parametrize('shape, out', [
    # output widths 1, 2 and 3 mod 4: rows that start inside a 16-byte line,
    # whose ends the kernel's 16-byte stores peel off
    ((2, 3, 13, 20), (50, 81)),
    ((1, 3, 9, 30), (37, 354)),
    ((1, 3, 9, 30), (37, 355)),
    ((1, 2, 10, 17), (40, 17)),      # OW = w
    ((1, 2, 12, 40), (12, 161)),     # OH = h
])
def test_seg_head_plain_matches_jax_at_store_widths(shape, out):
    """atol 1e-5: jax.image.resize rounds the sample coordinate
    (o + 0.5) * in / out - 0.5 in another order than the align_corners=False
    rule, an error that grows with the output index; at widths in the
    hundreds it moves a probability by up to 5e-6 at these logits."""
    x = (np.random.RandomState(shape[2]).randn(*shape) * 3).astype(np.float32)
    want = jax.nn.sigmoid(jax.image.resize(jnp.asarray(x), shape[:2] + out, method='bilinear'))
    got = seghead.seg_head_reference(torch.from_numpy(x), *out)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:2] + out
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert torch.equal(seghead.seg_head(torch.from_numpy(x), *out), got)


@pytest.mark.parametrize('out', [(8, 40), (20, 5)])
def test_seg_head_refuses_downsampling(out):
    with pytest.raises(ValueError, match='only upsamples'):
        seghead.seg_head(torch.zeros(1, 2, 10, 10), *out)


def test_ridge_bank_matches_jax():
    rows, cols, radius = jax_ridge._sato_kernel_bank(ridge.SIGMAS)
    p_rows, p_cols, p_radius = ridge._sato_kernel_bank(ridge.SIGMAS)
    assert radius == p_radius == 36
    np.testing.assert_array_equal(rows, p_rows)
    np.testing.assert_array_equal(cols, p_cols)
    # the kernel's constant bank: the non-zero taps of g0, g1, g2 per sigma
    bank = ridge.sato_kernel_bank()
    assert bank.dtype == np.float32 and bank.shape == (615,)
    np.testing.assert_array_equal(bank, np.concatenate(
        [jax_ridge._gauss_deriv_kernel(s, o) for s in ridge.SIGMAS for o in (0, 1, 2)]))


def _ridge_maps(n, h, w, seed):
    """Smooth line-like maps in [0, 1] with noise, like baseline heatmaps."""
    rng = np.random.RandomState(seed)
    maps = np.zeros((n, h, w), np.float32)
    yy = np.arange(h)[:, None]
    for i in range(n):
        for _ in range(4):
            y0, slope = rng.uniform(0, h), rng.uniform(-0.1, 0.1)
            maps[i] += np.exp(-0.5 * ((yy - y0 - slope * np.arange(w)[None]) / 2.0) ** 2)
    maps += 0.05 * rng.rand(n, h, w).astype(np.float32)
    return np.clip(maps, 0, 1).astype(np.float32)


@pytest.mark.parametrize('n, h, w', [(2, 64, 90), (1, 37, 150)])
def test_ridge_plain_matches_jax(n, h, w):
    maps = _ridge_maps(n, h, w, h + w)
    want = np.asarray(jax_ridge._sato_core_batch(jnp.asarray(maps)))
    got = ridge.sato_ridge_reference(torch.from_numpy(maps)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the thresholded wrapper on a (N, K, H, W) stack and a channel subset
    thr = 0.17
    stack = np.stack([np.zeros_like(maps), maps], 1)
    response = torch.empty((n, 1, h, w))
    mask = ridge.sato_ridge_threshold(torch.from_numpy(stack), (1,), thr, response)
    assert mask.dtype == torch.uint8 and tuple(mask.shape) == (n, 1, h, w)
    np.testing.assert_allclose(response[:, 0].numpy(), got, atol=1e-6)
    differ = mask[:, 0].numpy().astype(bool) != (want > thr)
    assert (np.abs(want[differ] - thr) <= 1e-5).all()
    assert (want > thr).any() and not (want > thr).all()


def test_ridge_wrapper_checks_channels():
    with pytest.raises(ValueError, match='channels'):
        ridge.sato_ridge_threshold(torch.zeros(1, 3, 8, 8), (3,), 0.17)
    with pytest.raises(ValueError, match='response'):
        ridge.sato_ridge_threshold(torch.zeros(1, 3, 8, 8), (0,), 0.17, torch.zeros(1, 2, 8, 8))


# the ridge's shipped and full-size maps and the kernel's edge cases: widths
# around the 128-wide tile and 1245, heights around the 16-row tile, maps
# thinner than a tile and than the largest radius, two pages
RIDGE_PLANES = [(1, 4, 512, 354), (1, 4, 1800, 1245), (2, 2, 45, 77), (1, 2, 40, 127),
                (1, 1, 41, 128), (1, 2, 42, 129), (1, 2, 20, 1245), (1, 2, 15, 200),
                (1, 2, 16, 200), (1, 2, 17, 200), (1, 2, 7, 300), (1, 2, 300, 7), (2, 2, 64, 150)]


@pytest.mark.parametrize('N, nc, H, W', RIDGE_PLANES)
def test_ridge_plan_fits_two_blocks_an_sm(N, nc, H, W):
    tw, th, threads, smem, grid = ridge.plan(N, nc, H, W)
    # 228 KB an SM, 1 KB of it reserved a block: 113 KB each for two blocks
    assert (tw, th, threads) == (128, 16, 256) and smem == 108_992 <= 113 << 10
    assert grid[1] == N * nc <= 65535


@pytest.mark.parametrize('N, nc, H, W', RIDGE_PLANES)
def test_ridge_grid_covers_every_pixel_once(N, nc, H, W):
    """Block (t, p) takes the tile at row (t // tiles_x) * TH and column
    (t % tiles_x) * TW of plane p, as the kernel computes it; together the
    tiles cover each pixel of each plane exactly once, and the 256 threads
    of a block own 8 pixels each."""
    tw, th, threads, _, (tiles, planes) = ridge.plan(N, nc, H, W)
    tiles_x = -(-W // tw)
    assert threads * 8 == tw * th and planes == N * nc
    hits = np.zeros((H, W), np.int32)
    for t in range(tiles):
        y0, x0 = (t // tiles_x) * th, (t % tiles_x) * tw
        assert y0 < H and x0 < W, 'a block with no pixel of the map'
        hits[y0:y0 + th, x0:x0 + tw] += 1
    assert (hits == 1).all()


def test_ridge_horizontal_loads_hit_distinct_banks():
    """The horizontal pass: warp w takes rows 8 (w // 4) + lane // 4 and the
    8 columns from 32 (w % 4) + 8 (lane % 4); the intermediates' row stride
    is the staged width + 1 (201 = 9 mod 32). One tap step's loads of a warp
    hit 32 distinct banks, and the 8 warps own the 128 x 16 tile once."""
    stride = ridge.TILE_W + 2 * ridge.MAX_RADIUS + 1
    assert stride % 32 == 9
    owned = np.zeros((ridge.TILE_H, ridge.TILE_W), np.int32)
    for warp in range(ridge.THREADS // 32):
        lanes = np.arange(32)
        rows = 8 * (warp // 4) + lanes // 4
        cols = 32 * (warp % 4) + 8 * (lanes % 4)
        for u in range(80):
            assert len(set((rows * stride + cols + u) % 32)) == 32
        for y, x in zip(rows, cols):
            owned[y, x:x + 8] += 1
    assert (owned == 1).all()


def test_ridge_macs_per_pixel():
    assert ridge.macs_per_pixel() == ridge.macs_per_pixel(128) == 1482.1875   # this kernel
    assert ridge.macs_per_pixel(32) == 2238.75     # the 32 x 32 tiles of the first design


def test_ridge_bound_counts_the_least_instructions():
    """The bound's count rests on the bank's symmetry (g0 and g2 even, g1
    odd, so a vertical tap pair shares its sum and difference among the 3
    components) and on its zero taps (g1's centre, g2's at ±sigma): per
    sigma of radius r, 5r + 1 instructions a pixel in the vertical pass and
    6r in the horizontal one."""
    bank = ridge.sato_kernel_bank()
    start = 0
    for sigma in ridge.SIGMAS:
        r = int(4 * sigma + 0.5)
        g0, g1, g2 = bank[start:start + 3 * (2 * r + 1)].reshape(3, 2 * r + 1)
        start += 3 * (2 * r + 1)
        np.testing.assert_array_equal(g0, g0[::-1])
        np.testing.assert_array_equal(g2, g2[::-1])
        np.testing.assert_array_equal(g1, -g1[::-1])
        assert np.flatnonzero(g1 == 0).tolist() == [r]
        assert np.flatnonzero(g2 == 0).tolist() == [r - sigma, r + sigma] and (g0 != 0).all()
    radii = [int(4 * sigma + 0.5) for sigma in ridge.SIGMAS]
    assert ridge.bound_slots_per_pixel() == sum(11 * r + 1 for r in radii) == 1105


def test_ridge_variants_apply_to_the_kernel_source():
    """Every version ``chip_smoke.py --ridge-variants`` builds is an edit of
    the kernel source that still finds its text there, exactly once."""
    import importlib.util
    spec = importlib.util.spec_from_file_location('chip_smoke', REPO / 'chip_smoke.py')
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    source = (REPO / 'kraken_tpu_torch' / 'csrc' / 'ridge.cu').read_text()
    for name, edits in smoke.RIDGE_VARIANTS.items():
        made = smoke.ridge_variant_source(name, source)
        assert (made == source) == (not edits), name
