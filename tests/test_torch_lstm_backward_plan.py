"""
The LSTM recurrence's backward kernel in its cluster design
(``csrc/lstm.cu:lstm_backward_cluster_kernel``) modelled in torch on the
CPU, and its route chooser (``ops/lstm.py:_backward_design``):

- the routes at the training shapes: the flagship and ``tpu`` presets'
  BiLSTM-200 at batch 16 and 64, ocropy's peephole LSTM-100 at 64 lines,
  the cluster/stream boundary (H = 460 / 470) and the stream route's
  H = 512; each pick fits a CTA's shared memory and threads, and takes the
  forward's cluster shape at the training shapes;
- the decomposition: CTA j of a cluster of C owns units
  [j*H/C, (j+1)*H/C) and holds their 4 gate rows of w_hh; each column k
  has one owner, ``((k+1)*C - 1) // H``; per step a CTA sends H*R floats
  and receives C partials of each of its cells;
- the model of the kernel (cells from the rank-order sum of the C partial
  dh_carry, each CTA's partial from its own w_hh slice and dgates) on both
  directions, ragged masks and peepholes, held within 1e-5 of the largest
  gradient to the plain version's autograd and to ``jax.grad`` of
  ``kraken_tpu/nn/layers.py:_lstm_scan`` / ``_peephole_scan``.

The kernel itself is held to the plain autograd on the card
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

from kraken_tpu.nn.layers import _lstm_scan, _peephole_scan
from kraken_tpu_torch.ops import lstm
from kraken_tpu_torch.ops.lstm import _backward_design, _backward_slots, _backward_smem, _design

SOURCE = Path(lstm.__file__).resolve().parent.parent / 'csrc' / 'lstm.cu'


# ------------------------------------------------------------------ routes

@pytest.mark.parametrize('shape, route', [
    ((16, 128, 2, 200), ('cluster', 8, 4)),      # flagship and `tpu` fits, batch 16
    ((64, 128, 2, 200), ('cluster', 8, 12)),     # batch 64
    ((64, 1024, 2, 100), ('cluster', 8, 12)),    # ocropy, peepholes
    ((4, 16, 2, 200), ('cluster', 8, 4)),
    ((9, 20, 2, 130), ('cluster', 8, 4)),
    ((16, 100, 2, 400), ('cluster', 16, 8)),
    ((16, 100, 2, 460), ('cluster', 16, 4)),     # the largest H a cluster holds
    ((16, 100, 2, 470), ('stream',)),
    ((3, 9, 2, 512), ('stream',)),
    ((16, 50, 2, 1024), ('stream',)),
    ((2, 5, 1, 7), ('stream',)),                 # fewer units than CTAs
])
def test_backward_route_at_the_training_shapes(shape, route):
    assert _backward_design(*shape) == route
    if shape[3] >= 8 and route[0] == 'cluster':
        assert _design(*shape) == route  # the forward's cluster shape


@pytest.mark.parametrize('H', [8, 25, 64, 100, 128, 199, 200, 256, 320, 400, 459, 460])
@pytest.mark.parametrize('B', [1, 16, 64, 512])
def test_every_cluster_pick_fits_a_cta(B, H):
    route = _backward_design(B, 50, 2, H)
    assert route[0] == 'cluster'
    _, C, R = route
    assert R % 4 == 0 and C in lstm.CLUSTER_SIZES
    assert _backward_smem(H, C, R) <= lstm.SMEM_PER_CTA
    assert _backward_slots(H, C, R) <= lstm.MAX_SLOTS


def test_constants_are_the_kernel_sources():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf'constexpr int {name} = (\d+);', src).group(1))
    assert lstm.MAX_SLOTS == const('CLUSTER_THREADS') * const('MAX_ITERS')
    body = src[src.index('BackwardShape backward_cluster_shape'):]
    body = body[:body.index('\n}\n')]
    # the smem the Python mirror counts, term by term
    for term in ('(size_t)s.units * s.hp', '2 * (size_t)C * s.units * RG',
                 '2 * (size_t)4 * RG * s.units', '2 * sizeof(uint64_t)'):
        assert term in body
    assert _backward_smem(200, 8, 4) == 16 * (25 * 204 + 2 * 8 * 25 + 2 * 4 * 25) + 16


# ---------------------------------------------------------- decomposition

def units_of(H: int, C: int) -> list:
    return [range(j * H // C, (j + 1) * H // C) for j in range(C)]


@pytest.mark.parametrize('H, C', [(8, 8), (25, 8), (100, 8), (130, 8), (200, 8), (201, 8),
                                  (400, 16), (460, 16), (17, 16)])
def test_each_column_has_one_owner(H, C):
    ranks = units_of(H, C)
    assert sorted(k for U in ranks for k in U) == list(range(H))
    max_units = -(-H // C)
    for k in range(H):
        owner = ((k + 1) * C - 1) // H  # the kernel's formula
        assert k in ranks[owner]
        assert 0 <= k - owner * H // C < max_units


@pytest.mark.parametrize('H, C, R', [(200, 8, 4), (200, 8, 12), (100, 8, 12), (460, 16, 4)])
def test_exchange_volume_is_the_forwards(H, C, R):
    """Each CTA sends its partial of all H columns for R rows (H*R floats)
    and receives C partials of each of its cells: the volume of the
    forward's h exchange."""
    ranks = units_of(H, C)
    received = [C * len(U) * (R // 4) * 16 for U in ranks]  # the kernel's step_bytes
    assert sum(received) == C * H * R * 4
    sent_each = H * R * 4
    assert sum(received) == C * sent_each


# ------------------------------------------------------------------- model

def saving_forward(gates_x, w_hh, mask, reverse, peephole):
    """What the forward kernel's saving mode writes, from the plain loop:
    the activated gates, the cell carry after each step (frozen at a masked
    step) and the h carry before it, float32."""
    B, T, D, G = gates_x.shape
    H = G // 4
    gates = torch.zeros(B, T, D, G)
    cs = torch.zeros(B, T, D, H)
    hs = torch.zeros(B, T, D, H)
    for d in range(D):
        h, c = torch.zeros(B, H), torch.zeros(B, H)
        steps = range(T - 1, -1, -1) if (d == 1) != reverse else range(T)
        for t in steps:
            pre = gates_x[:, t, d] + h @ w_hh[d].t()
            i, f, g, o = pre.chunk(4, dim=1)
            if peephole is None:
                i, f, o, g = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o), torch.tanh(g)
                c_new = f * c + i * g
            else:
                w_ip, w_fp, w_op = peephole[d]
                i, f, g = torch.sigmoid(i + w_ip * c), torch.sigmoid(f + w_fp * c), torch.tanh(g)
                c_new = f * c + i * g
                o = torch.sigmoid(o + w_op * c_new)
            m = mask[:, t, None]
            gates[:, t, d] = torch.cat([i, f, g, o], dim=1)
            hs[:, t, d] = h
            h = torch.where(m, o * torch.tanh(c_new), h)
            c = torch.where(m, c_new, c)
            cs[:, t, d] = c
    return gates, cs, hs


def cluster_backward(dout, gates, cs, w_hh, mask, reverse, peephole, C, R):
    """
    The kernel's decomposition: per (tile of R rows, direction) a cluster of
    C CTAs, CTA j owning units U_j with its slice of w_hh (4, |U_j|, H).
    Per step, in the reverse of the direction's forward order, CTA j's cells
    take dh_carry from the rank-order sum of the C partials of the step
    before (where that step was valid), take the step (dgates, the dc
    carry), and CTA j forms its partial dh_carry over all H columns from its
    dgates and its slice; column k's partial goes to k's owner.
    """
    B, T, D, G = gates.shape
    H = G // 4
    ranks = units_of(H, C)
    dgates = torch.zeros(B, T, D, G)
    for d in range(D):
        rev = (d == 1) != reverse
        slices = [w_hh[d].reshape(4, H, H)[:, U.start:U.stop] for U in ranks]
        pw = None if peephole is None else peephole[d]
        for row0 in range(0, B, R):
            rows = range(row0, min(row0 + R, B))
            n = len(rows)
            dh = [torch.zeros(n, len(U)) for U in ranks]
            dc = [torch.zeros(n, len(U)) for U in ranks]
            live_prev = torch.zeros(n, dtype=torch.bool)
            recv = None
            for s in range(T):
                sf = T - 1 - s
                t = T - 1 - sf if rev else sf
                tp = t + 1 if rev else t - 1
                live = mask[rows.start:rows.stop, t]
                dg_ranks = []
                for j, U in enumerate(ranks):
                    u = slice(U.start, U.stop)
                    if s > 0:
                        total = torch.zeros(n, len(U))
                        for src in range(C):  # rank order
                            total = total + recv[j][src]
                        dh[j] = torch.where(live_prev[:, None], total, dh[j])
                    g = gates[rows.start:rows.stop, t, d].reshape(n, 4, H)[:, :, u]
                    ig, fg, gg, og = g.unbind(1)
                    c_t = cs[rows.start:rows.stop, t, d, u]
                    c_prev = cs[rows.start:rows.stop, tp, d, u] if sf > 0 else torch.zeros_like(c_t)
                    tc = torch.tanh(c_t)
                    dht = dout[rows.start:rows.stop, t, d, u] + dh[j]
                    dpo = dht * tc * og * (1 - og)
                    dct = dc[j] + dht * og * (1 - tc * tc)
                    if pw is not None:
                        dct = dct + dpo * pw[2, u]
                    dpi = dct * gg * ig * (1 - ig)
                    dpg = dct * ig * (1 - gg * gg)
                    dpf = dct * c_prev * fg * (1 - fg)
                    dcp = dct * fg
                    if pw is not None:
                        dcp = dcp + dpi * pw[0, u] + dpf * pw[1, u]
                    m = live[:, None]
                    dc[j] = torch.where(m, dcp, dc[j])
                    dg = torch.where(m[:, None], torch.stack([dpi, dpf, dpg, dpo], 1), 0.0)
                    dgates[rows.start:rows.stop, t, d].view(n, 4, H)[:, :, u] = dg
                    dg_ranks.append(dg)
                live_prev = live
                if s + 1 < T:
                    partials = [torch.einsum('bqu,quk->bk', dg_ranks[j], slices[j])
                                for j in range(C)]
                    recv = [[partials[src][:, U.start:U.stop] for src in range(C)] for U in ranks]
    return dgates


def model_grads(gates_x, w_hh, mask, reverse, peephole, up, C, R):
    """The gradients LSTMRecurrence.backward returns, with the model in the
    kernel's place: gates_x's, w_hh's (Σ dgates ⊗ h_before) and the
    peephole weights'."""
    gates, cs, hs = saving_forward(gates_x, w_hh, mask, reverse, peephole)
    dgates = cluster_backward(up, gates, cs, w_hh, mask, reverse, peephole, C, R)
    grads = [dgates, torch.einsum('btdg,btdh->dgh', dgates, hs)]
    if peephole is not None:
        H = cs.shape[3]
        before = lstm._shift_carry(cs, reverse)
        grads.append(torch.stack([(dgates[..., :H] * before).sum(dim=(0, 1)),
                                  (dgates[..., H:2 * H] * before).sum(dim=(0, 1)),
                                  (dgates[..., 3 * H:] * cs).sum(dim=(0, 1))], dim=1))
    return grads


def close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rel * max(1.0, float(np.abs(want).max()))


CASES = {
    'flagship_like': (6, 9, 2, 19, [9, 4, 1, 9, 7, 2], False, 8, 4),
    'one_direction_ragged': (5, 8, 1, 16, [8, 3, 5, 1, 6], False, 8, 4),
    'peephole': (3, 7, 2, 17, None, True, 16, 4),
    'rows_in_three_tiles': (9, 6, 2, 24, [6, 6, 2, 5, 1, 6, 3, 4, 6], False, 8, 4),
    'tile_of_8': (5, 6, 2, 12, [6, 2, 5, 1, 4], False, 8, 8),
}


def case_inputs(B, T, D, H, lens, peep, seed):
    rng = np.random.RandomState(seed)
    f = np.float32
    x = rng.randn(B, T, 5).astype(f)
    w_ih = (0.4 * rng.randn(D, 4 * H, 5)).astype(f)
    w_hh = (0.4 * rng.randn(D, 4 * H, H)).astype(f)
    b = np.zeros((D, 4 * H), f) if peep else (0.1 * rng.randn(D, 4 * H)).astype(f)
    p = (0.5 * rng.randn(D, 3, H)).astype(f) if peep else None
    up = rng.randn(B, T, D, H).astype(f)
    lens = np.full(B, T) if lens is None else np.asarray(lens)
    return x, w_ih, w_hh, b, p, up, lens


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('case', sorted(CASES))
def test_cluster_model_matches_plain_autograd(case, reverse):
    B, T, D, H, lens, peep, C, R = CASES[case]
    x, w_ih, w_hh, b, p, up, lens = case_inputs(B, T, D, H, lens, peep, len(case) + int(reverse))
    gates_x = torch.einsum('btc,dgc->btdg', torch.from_numpy(x), torch.from_numpy(w_ih)) \
        + torch.from_numpy(b)
    mask = torch.arange(T)[None, :] < torch.from_numpy(lens)[:, None]
    w = torch.from_numpy(w_hh)
    peephole = None if p is None else torch.from_numpy(p)
    got = model_grads(gates_x, w, mask, reverse, peephole, torch.from_numpy(up), C, R)
    leaves = [gates_x.clone().requires_grad_(True), w.clone().requires_grad_(True)]
    pl = None if peephole is None else peephole.clone().requires_grad_(True)
    out = lstm.lstm_recurrence_reference(leaves[0], leaves[1], mask, reverse, peephole=pl)
    (out * torch.from_numpy(up)).sum().backward()
    want = [t.grad for t in leaves] + ([] if pl is None else [pl.grad])
    for a, e in zip(got, want):
        close(a, e)


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('case', sorted(CASES))
def test_cluster_model_matches_jax_grad(case, reverse):
    """Each direction d against ``jax.grad`` of the JAX scan with its own
    weights (direction 1 runs opposite to direction 0): dx, dW_ih, dW_hh,
    db, and the peephole weights' gradients."""
    B, T, D, H, lens, peep, C, R = CASES[case]
    x, w_ih, w_hh, b, p, up, lens = case_inputs(B, T, D, H, lens, peep, len(case) + int(reverse))
    tx, tw_ih = torch.from_numpy(x), torch.from_numpy(w_ih)
    gates_x = torch.einsum('btc,dgc->btdg', tx, tw_ih) + torch.from_numpy(b)
    mask = torch.arange(T)[None, :] < torch.from_numpy(lens)[:, None]
    peephole = None if p is None else torch.from_numpy(p)
    got = model_grads(gates_x, torch.from_numpy(w_hh), mask, reverse, peephole,
                      torch.from_numpy(up), C, R)
    dgates = got[0]
    dx = torch.einsum('btdg,dgc->btc', dgates, tw_ih)
    jl = None if peep else jnp.asarray(lens)
    want_dx = np.zeros_like(x)
    for d in range(D):
        rev = (d == 1) != reverse
        if peep:
            def loss(x, w_ih, w_hh, pd, d=d, rev=rev):
                y = _peephole_scan(x, w_ih, w_hh, pd[0], pd[1], pd[2], rev)
                return (y * up[:, :, d]).sum()
            args = (x, w_ih[d], w_hh[d], p[d])
        else:
            def loss(x, w_ih, w_hh, bd, d=d, rev=rev):
                return (_lstm_scan(x, jl, w_ih, w_hh, bd, rev) * up[:, :, d]).sum()
            args = (x, w_ih[d], w_hh[d], b[d])
        g = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*map(jnp.asarray, args))
        want_dx += np.asarray(g[0])
        close(torch.einsum('btg,btc->gc', dgates[:, :, d], tx), g[1])
        close(got[1][d], g[2])
        close(got[2][d] if peep else dgates[:, :, d].sum(dim=(0, 1)), g[3])
    close(dx, want_dx)


def test_the_cpu_counts_no_backward_launch():
    before = dict(lstm.lstm_recurrence.backward_design_launches)
    g = torch.randn(2, 3, 1, 8, requires_grad=True)
    lstm.lstm_recurrence(g, torch.randn(1, 8, 2), torch.ones(2, 3, dtype=torch.bool)).sum().backward()
    assert lstm.lstm_recurrence.backward_design_launches == before
    assert g.grad is not None
