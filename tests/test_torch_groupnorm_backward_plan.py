"""
The GroupNorm backward kernel (``csrc/groupnorm.cu``, one launch a call)
modelled in torch on the CPU, and its route chooser
(``ops/groupnorm.py:_backward_design``, ``_l2_plan``):

- the routes at the training layers: the default segtrain spec's four at
  height 1800 take ``l2``, the ``tpu`` preset's three (16 ragged lines)
  ``cluster`` with 16, 4 and 1 CTAs (three CTAs an SM); the shared memory
  the Python mirror counts is the source's, term by term;
- the cluster route's decomposition: CTA j of CL takes rows
  [j*rows/CL, (j+1)*rows/CL) of its group, forms (A, B) = (Σ dy·x̂, Σ dy)
  over the valid columns of each channel its rows touch, and every CTA
  merges the CL·Cg partials in one fixed order;
- the l2 route's plan: every element lies in exactly one item of a whole
  number of 16-byte units' worth (``per`` a multiple of 4), a group's items
  never outnumber the grid, at most 35 MB of x and dy lie between their
  two reads (two items a CTA); a model of the cooperative schedule (each
  CTA takes its items in order and sums the next before it waits for the
  group of the current one) ends at every training
  layer with at most 35 MB of x and dy in flight, and deadlocks where a
  group outnumbers twice the grid (the plan keeps it within the grid);
- both models' dx, d weight and d bias held within 2e-4 of the largest to
  the plain version's float64 autograd and to ``jax.grad`` of
  ``kraken_tpu/nn/layers.py:GroupNorm.apply`` (the bound of the gradient parity test: the JAX
  forward takes its variance in one fp32 pass), ragged and not, with dx 0
  at every pad column.

The kernel itself is held to float64 autograd on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 22).
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kraken_tpu.nn.layers import GroupNorm as JaxGroupNorm
from kraken_tpu_torch.ops import groupnorm
from kraken_tpu_torch.ops.groupnorm import (BWD_CLUSTER_SIZES, BWD_SMEM_SHARED, L2_CTAS_PER_SM,
                                            L2_ITEM, _backward_design, _bwd_cluster_smem,
                                            _l2_plan, group_norm_reference)

SOURCE = Path(groupnorm.__file__).resolve().parent.parent / 'csrc' / 'groupnorm.cu'
H100_CAPACITY = L2_CTAS_PER_SM * 132  # the l2 route's grid on an H100 (2 CTAs an SM)
SEGTRAIN = [((1, 64, 900, 623), 32), ((1, 128, 450, 312), 32), ((1, 256, 450, 312), 32)]
TPU = [((16, 128, 60, 512), 32), ((16, 128, 30, 256), 32), ((16, 128, 15, 128), 32)]


# ------------------------------------------------------------------ routes

@pytest.mark.parametrize('shape, G, route', [(s, G, ('l2',)) for s, G in SEGTRAIN]
                         + [(TPU[0][0], 32, ('cluster', 16, 15)), (TPU[1][0], 32, ('cluster', 4, 30)),
                            (TPU[2][0], 32, ('cluster', 1, 60))])
def test_backward_route_at_the_training_layers(shape, G, route):
    assert _backward_design(*shape, G) == route


@pytest.mark.parametrize('shape, G', SEGTRAIN + TPU + [((1, 32, 256, 177), 8), ((3, 8, 7, 5), 2),
                                                       ((2, 512, 40, 60), 1)])
def test_cluster_picks_fit_a_cta(shape, G):
    route = _backward_design(*shape, G)
    rows, Cg = (shape[1] // G) * shape[2], shape[1] // G
    fits = {CL: _bwd_cluster_smem(-(-rows // CL), shape[3], Cg)
            for CL in sorted({min(size, rows) for size in BWD_CLUSTER_SIZES})}
    if route[0] == 'cluster':
        _, CL, R = route
        assert R == -(-rows // CL) and fits[CL] <= groupnorm.SMEM_PER_CTA
        # three CTAs an SM where some size allows it, else the smallest that fits
        shared = [k for k, v in fits.items() if v <= BWD_SMEM_SHARED]
        assert CL == (shared[0] if shared else min(k for k, v in fits.items()
                                                     if v <= groupnorm.SMEM_PER_CTA))
        assert 3 * (BWD_SMEM_SHARED + 2048) <= 233472
    else:
        assert all(v > groupnorm.SMEM_PER_CTA for v in fits.values())


def test_constants_are_the_kernel_sources():
    src = SOURCE.read_text()
    body = src[src.index('size_t bwd_cluster_smem('):]
    body = body[:body.index('\n}\n')]
    for term in ('2 * slice_bytes(rows, W, sizeof(float))', '4 * (size_t)rows', '8 * (size_t)Cg'):
        assert term in body
    # the kernel's launch bounds hold the grid's CTAs an SM
    assert int(re.search(r'constexpr int kL2MinBlocksPerSM = (\d+);', src).group(1)) \
        == L2_CTAS_PER_SM
    assert L2_ITEM % 4 == 0


# ------------------------------------------------------------ the models

def forward_stats(x, G, lens):
    """The forward's (mean, rstd) of each (sample, group), float32."""
    N, C, H, W = x.shape
    L = torch.full((N,), W) if lens is None else torch.clamp(torch.as_tensor(lens), 1, W)
    m = (torch.arange(W)[None, :] < L[:, None]).float()[:, None, None, None, :]
    xg = x.reshape(N, G, C // G, H, W)
    count = ((C // G) * H * L.float())[:, None, None, None, None]
    mean = (xg * m).sum(dim=(2, 3, 4), keepdim=True) / count
    var = (((xg - mean) ** 2) * m).sum(dim=(2, 3, 4), keepdim=True) / count
    return mean.reshape(N, G), torch.rsqrt(var + 1e-5).reshape(N, G), L


def dx_from_means(x, dy, w, G, mean, rstd, L, ma, mb):
    """dx = rstd (dy w - mb - x̂ ma) on the valid columns, 0 beyond."""
    N, C, H, W = x.shape
    rep = C // G
    mean_c, rstd_c = mean.repeat_interleave(rep, 1), rstd.repeat_interleave(rep, 1)
    ma_c, mb_c = ma.repeat_interleave(rep, 1), mb.repeat_interleave(rep, 1)
    xh = (x - mean_c[..., None, None]) * rstd_c[..., None, None]
    dx = rstd_c[..., None, None] * (dy * w[None, :, None, None] - mb_c[..., None, None]
                                    - xh * ma_c[..., None, None])
    valid = torch.arange(W)[None, None, None, :] < L[:, None, None, None]
    return dx * valid


def cluster_model(x, dy, w, G, lens, CL):
    """The cluster route: per (sample, group) CL CTAs, each with the (A, B)
    of every channel its rows touch; every CTA merges the CL·Cg partials in
    one fixed order (CTA-major). Returns dx, d weight, d bias."""
    N, C, H, W = x.shape
    Cg, rows = C // G, (C // G) * H
    mean, rstd, L = forward_stats(x, G, lens)
    partial = torch.zeros(N, G, CL, Cg, 2)
    ma, mb = torch.zeros(N, G), torch.zeros(N, G)
    for n in range(N):
        for g in range(G):
            xg = x[n, g * Cg:(g + 1) * Cg].reshape(rows, W)[:, :L[n]]
            dg = dy[n, g * Cg:(g + 1) * Cg].reshape(rows, W)[:, :L[n]]
            for j in range(CL):
                r0, r1 = j * rows // CL, (j + 1) * rows // CL
                for cl in range(r0 // H, (r1 - 1) // H + 1):
                    sa, sb = max(r0, cl * H), min(r1, (cl + 1) * H)
                    d = dg[sa:sb]
                    partial[n, g, j, cl, 0] = (d * ((xg[sa:sb] - mean[n, g]) * rstd[n, g])).sum()
                    partial[n, g, j, cl, 1] = d.sum()
            a = b = 0.0
            for j in range(CL):
                for cl in range(Cg):
                    a = a + w[g * Cg + cl] * partial[n, g, j, cl, 0]
                    b = b + w[g * Cg + cl] * partial[n, g, j, cl, 1]
            count = Cg * H * int(L[n])
            ma[n, g], mb[n, g] = a / count, b / count
    sums = partial.sum(dim=(0, 2)).reshape(C, 2)
    return dx_from_means(x, dy, w, G, mean, rstd, L, ma, mb), sums[:, 0], sums[:, 1]


def l2_items(shape, G, capacity):
    """The l2 route's launch: its items, (plane, first, end) element ranges
    of a plane, plane-major; each item's group; and its works, runs of K
    consecutive items of one group, group-major."""
    N, C, H, W = shape
    per, S, K, grid = _l2_plan(N, C, H, W, G, capacity)
    items = [(nc, s * per, min((s + 1) * per, H * W)) for nc in range(N * C) for s in range(S)]
    group = [(nc // C) * G + (nc % C) // (C // G) for nc, _, _ in items]
    n_group = (C // G) * S
    works = [list(range(g * n_group + j, min(g * n_group + j + K, (g + 1) * n_group)))
             for g in range(N * G) for j in range(0, n_group, K)]
    return items, group, works, per, S, K, grid


def l2_schedule(items, group: list, works: list, grid: int) -> tuple[bool, float]:
    """The cooperative launch's schedule: CTA i takes works i, i + grid, ...
    in order. It sums its first work's items, then for each work sums the
    next one's (their flags are set) before it waits until all items of the
    current one's group have their flags, then writes the current one's
    dx. Returns (whether every item was written, the most bytes of x and dy
    in flight at once: of items summed and not yet written)."""
    members = {}
    for i, g in enumerate(group):
        members.setdefault(g, []).append(i)
    queues = [works[j::grid] for j in range(min(grid, len(works)))]
    summed, applied = [0] * len(queues), [0] * len(queues)
    flagged, written = [False] * len(items), [False] * len(items)
    most = 0
    while True:
        moved = False
        for k, q in enumerate(queues):
            while summed[k] < len(q) and summed[k] <= applied[k] + 1:
                for i in q[summed[k]]:
                    flagged[i] = moved = True
                summed[k] += 1
        most = max(most, sum(8 * (e1 - e0) for i, (_, e0, e1) in enumerate(items)
                             if flagged[i] and not written[i]))
        for k, q in enumerate(queues):
            if applied[k] < len(q) and all(flagged[m] for m in members[group[q[applied[k]][0]]]):
                for i in q[applied[k]]:
                    written[i] = moved = True
                applied[k] += 1
        if all(written):
            return True, most
        if not moved:
            return False, most


def l2_model(x, dy, w, G, lens, capacity):
    """The l2 route: each item's (A, B) over its elements on valid columns,
    the group's Σ_c w_c (A, B) over its items in item order, dx."""
    N, C, H, W = x.shape
    mean, rstd, L = forward_stats(x, G, lens)
    items, group, _, per, S, _, _ = l2_items(x.shape, G, capacity)
    flat_x, flat_dy = x.reshape(N * C, H * W), dy.reshape(N * C, H * W)
    col = torch.arange(H * W) % W
    partial = torch.zeros(len(items), 2)
    for i, (nc, e0, e1) in enumerate(items):
        n, ng = nc // C, group[i]
        keep = col[e0:e1] < L[n]
        d = flat_dy[nc, e0:e1][keep]
        partial[i, 0] = (d * ((flat_x[nc, e0:e1][keep] - mean.view(-1)[ng]) * rstd.view(-1)[ng])).sum()
        partial[i, 1] = d.sum()
    ma, mb = torch.zeros(N * G), torch.zeros(N * G)
    for i, (nc, _, _) in enumerate(items):
        ma[group[i]] += w[nc % C] * partial[i, 0]
        mb[group[i]] += w[nc % C] * partial[i, 1]
    count = torch.tensor([(C // G) * H * int(L[ng // G]) for ng in range(N * G)], dtype=torch.float32)
    ma, mb = (ma / count).view(N, G), (mb / count).view(N, G)
    sums = partial.view(N, C, S, 2).sum(dim=(0, 2))
    return dx_from_means(x, dy, w, G, mean, rstd, L, ma, mb), sums[:, 0], sums[:, 1]


# ------------------------------------------------------------- l2 plan

@pytest.mark.parametrize('shape, G', SEGTRAIN + TPU + [((3, 8, 7, 5), 2), ((2, 512, 40, 60), 1)])
def test_l2_items_cover_each_element_once_and_fit_the_grid(shape, G):
    items, group, works, per, S, K, grid = l2_items(shape, G, H100_CAPACITY)
    N, C, H, W = shape
    assert per % 4 == 0 and per >= L2_ITEM
    taken = np.zeros((N * C, H * W), np.int64)
    for nc, e0, e1 in items:
        taken[nc, e0:e1] += 1
    assert (taken == 1).all()
    assert sorted(i for w in works for i in w) == list(range(len(items)))
    assert all(len({group[i] for i in w}) == 1 for w in works)
    # a group's works never outnumber the grid; one item a work unless a
    # group has more channels than the grid CTAs
    assert -(-(C // G) * S // K) <= grid <= H100_CAPACITY
    assert K == 1 or (S == 1 and C // G > H100_CAPACITY)
    # x and dy of the items between their two reads, two a CTA: at most 35 MB
    assert 2 * grid * K * min(per, H * W) * 8 <= 35e6


@pytest.mark.parametrize('shape, G', SEGTRAIN + TPU)
def test_l2_schedule_ends_with_little_in_flight(shape, G):
    """Every item is written, and the items summed and not yet written
    hold at most 35 MB of x and dy (four of segtrain's 9 MB groups): the
    second reads find them in the card's 50 MB L2."""
    items, group, works, per, S, K, grid = l2_items(shape, G, H100_CAPACITY)
    done, most = l2_schedule(items, group, works, grid)
    assert done
    assert most <= 35e6


def test_l2_schedule_of_a_group_of_more_channels_than_ctas():
    """512 channels in one group: works of K = 2 planes, and every item is
    written."""
    items, group, works, per, S, K, grid = l2_items((2, 512, 40, 60), 1, H100_CAPACITY)
    assert (S, K) == (1, 2) and l2_schedule(items, group, works, grid)[0]


def test_l2_schedule_deadlocks_where_a_group_outnumbers_the_grid():
    """Why the plan bounds a group's works by the grid: with the next work
    summed before the wait, a group may span twice the grid; beyond that
    every CTA waits for a work no CTA can reach."""
    items, group, works, _, S, K, grid = l2_items((1, 64, 900, 623), 32, H100_CAPACITY)
    assert K == 1 and 2 * S <= grid
    assert not l2_schedule(items, group, works, S - 1)[0]
    assert l2_schedule(items, group, works, S)[0]


# ------------------------------------------------------------- gradients

CASES = {
    'tpu_like_ragged': ((3, 8, 6, 37), 2, [37, 12, 1], 4),
    'rows_split_in_channels': ((2, 12, 5, 23), 3, [9, 23], 8),
    'unragged': ((2, 16, 4, 40), 4, None, 8),
    'sixteen_ctas': ((1, 8, 9, 31), 2, [20], 16),
}


def case_inputs(shape, G, seed):
    rng = np.random.RandomState(seed)
    x = np.maximum(rng.randn(*shape), 0).astype(np.float32)
    w = (1 + 0.1 * rng.randn(shape[1])).astype(np.float32)
    b = (0.1 * rng.randn(shape[1])).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    return x, w, b, dy


def close(got, want, rel=2e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rel * max(1.0, float(np.abs(want).max()))


# items of 8 elements at these small shapes: several items a plane, their
# ends inside rows and 16-byte units
SMALL_ITEM = 8


@pytest.mark.parametrize('route', ['cluster', 'l2'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_route_models_match_plain_autograd_and_jax(case, route, monkeypatch):
    shape, G, lens, CL = CASES[case]
    x, w, b, dy = case_inputs(shape, G, sum(shape))
    tx, tw, tdy = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(dy)
    if route == 'cluster':
        got = cluster_model(tx, tdy, tw, G, lens, CL)
    else:
        monkeypatch.setattr(groupnorm, 'L2_ITEM', SMALL_ITEM)
        got = l2_model(tx, tdy, tw, G, lens, H100_CAPACITY)
    seq = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    leaves = [torch.from_numpy(a).double().requires_grad_(True) for a in (x, w, b)]
    (group_norm_reference(*leaves, G, 1e-5, seq) * tdy.double()).sum().backward()
    for a, e in zip(got, [t.grad for t in leaves]):
        close(a, e)
    layer = JaxGroupNorm(shape[1], G)

    def loss(x, w, b):
        y, _ = layer.apply({'layer.weight': w, 'layer.bias': b}, x,
                           None if lens is None else jnp.asarray(lens, jnp.int32))
        return (y * dy).sum()
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*map(jnp.asarray, (x, w, b)))
    for a, e in zip(got, want):
        close(a, e)
    if lens is not None:
        for n, L in enumerate(lens):
            assert not got[0][n, :, :, L:].any()


def test_l2_items_at_the_model_and_training_sizes(monkeypatch):
    """The l2 gradient cases split each plane into several items whose
    ends fall inside rows; a segtrain layer's planes take 69 items of
    L2_ITEM elements, a group's 2 x 69 on the full grid."""
    items, group, works, per, S, K, grid = l2_items((1, 64, 900, 623), 32, H100_CAPACITY)
    assert (per, S, K, grid) == (L2_ITEM, 69, 1, H100_CAPACITY)
    monkeypatch.setattr(groupnorm, 'L2_ITEM', SMALL_ITEM)
    for shape, G, _, _ in CASES.values():
        items, group, works, per, S, K, grid = l2_items(shape, G, H100_CAPACITY)
        assert per == SMALL_ITEM and S > 2 and any(e0 % shape[3] for _, e0, _ in items)
        assert K == 1 and (shape[1] // G) * S <= grid
