"""
The port's LSTM recurrence (kraken_tpu_torch.ops.lstm) against the JAX
package: the Pallas kernel in interpret mode and the lax.scan path, on the
same numpy-seeded inputs; the CPU wrapper's plain path; the CUDA kernel
against its plain version where a card is present.
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from kraken_tpu.nn.layers import _lstm_scan
from kraken_tpu.ops.lstm import lstm_pallas
from kraken_tpu_torch.ops import build
from kraken_tpu_torch.ops.lstm import (MAX_SLOTS, SMEM_PER_CTA, WAVE_CLUSTERS, _cluster_smem,
                                       _design, _units, lstm_recurrence,
                                       lstm_recurrence_reference)

B, T, H, C = 4, 16, 8, 12
LENS = np.array([16, 10, 3, 1])


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    w_ih = rng.randn(4 * H, C).astype(np.float32) * 0.1
    w_hh = rng.randn(4 * H, H).astype(np.float32) * 0.1
    b = rng.randn(4 * H).astype(np.float32) * 0.1
    x = rng.randn(B, T, C).astype(np.float32)
    gates = (x @ w_ih.T + b).astype(np.float32)
    mask = (np.arange(T)[None, :] < LENS[:, None])
    return x, w_ih, w_hh, b, gates, mask


@pytest.mark.parametrize('reverse', [False, True])
def test_reference_matches_pallas_interpret(reverse):
    x, w_ih, w_hh, b, gates, mask = _inputs()
    pal = lstm_pallas(jnp.asarray(gates), jnp.asarray(w_hh), jnp.asarray(mask.astype(np.float32)),
                      reverse=reverse, interpret=True)
    out = lstm_recurrence_reference(torch.from_numpy(gates)[:, :, None],
                                    torch.from_numpy(w_hh)[None],
                                    torch.from_numpy(mask), reverse)
    np.testing.assert_allclose(out[:, :, 0].numpy(), np.asarray(pal), atol=1e-5)


@pytest.mark.parametrize('reverse', [False, True])
def test_reference_matches_scan(reverse):
    x, w_ih, w_hh, b, gates, mask = _inputs(1)
    ref = _lstm_scan(jnp.asarray(x), jnp.asarray(LENS), jnp.asarray(w_ih),
                     jnp.asarray(w_hh), jnp.asarray(b), reverse)
    out = lstm_recurrence_reference(torch.from_numpy(gates)[:, :, None],
                                    torch.from_numpy(w_hh)[None],
                                    torch.from_numpy(mask), reverse)
    np.testing.assert_allclose(out[:, :, 0].numpy(), np.asarray(ref), atol=1e-5)


def test_bidirectional_call_is_two_directions():
    """D=2 runs direction 0 forward and direction 1 backward in one call."""
    *_, gates_f, mask = _inputs(2)
    *_, gates_r, _ = _inputs(3)
    rng = np.random.RandomState(4)
    w = torch.from_numpy(rng.randn(2, 4 * H, H).astype(np.float32) * 0.1)
    gf, gr, m = torch.from_numpy(gates_f), torch.from_numpy(gates_r), torch.from_numpy(mask)
    both = lstm_recurrence_reference(torch.stack([gf, gr], dim=2), w, m)
    fwd = lstm_recurrence_reference(gf[:, :, None], w[:1], m, False)
    bwd = lstm_recurrence_reference(gr[:, :, None], w[1:], m, True)
    assert torch.equal(both[:, :, :1], fwd)
    assert torch.equal(both[:, :, 1:], bwd)
    # masked steps emit zeros; a row of length 1 has only its first step
    assert torch.all(both[3, 1:] == 0) and torch.any(both[3, 0] != 0)


def test_cpu_wrapper_takes_plain_path():
    *_, gates, mask = _inputs()
    w = torch.from_numpy(np.random.RandomState(5).randn(1, 4 * H, H).astype(np.float32))
    g, m = torch.from_numpy(gates)[:, :, None], torch.from_numpy(mask)
    before = lstm_recurrence.launches
    out = lstm_recurrence(g, w, m, True)
    assert torch.equal(out, lstm_recurrence_reference(g, w, m, True))
    assert lstm_recurrence.launches == before


def test_bf16_carry_is_fp32():
    """bf16 inputs and outputs, fp32 carry: the result is the fp32
    recurrence on the bf16-rounded inputs, rounded once to bf16."""
    *_, gates, mask = _inputs(6)
    w = torch.from_numpy(np.random.RandomState(7).randn(1, 4 * H, H).astype(np.float32) * 0.1)
    g16 = torch.from_numpy(gates)[:, :, None].to(torch.bfloat16)
    m = torch.from_numpy(mask)
    out = lstm_recurrence_reference(g16, w, m)
    assert out.dtype == torch.bfloat16
    ref = lstm_recurrence_reference(g16.to(torch.float32), w, m).to(torch.bfloat16)
    assert torch.equal(out, ref)


@pytest.mark.parametrize('bad', ['gates_rank', 'w_shape', 'mask_shape', 'device'])
def test_wrapper_rejects_bad_input(bad):
    g = torch.zeros(2, 3, 1, 4 * H)
    w = torch.zeros(1, 4 * H, H)
    m = torch.ones(2, 3, dtype=torch.bool)
    if bad == 'gates_rank':
        g = g[:, :, 0]
    elif bad == 'w_shape':
        w = torch.zeros(4 * H, H)
    elif bad == 'mask_shape':
        m = m[:, :2]
    else:
        g, w, m = g.to('meta'), w.to('meta'), m.to('meta')
    with pytest.raises(ValueError):
        lstm_recurrence(g, w, m)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc means an error, never a fallback."""
    monkeypatch.setattr(build.shutil, 'which', lambda name: None)
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    with pytest.raises(RuntimeError, match='nvcc'):
        build._nvcc()


@pytest.mark.parametrize('B', [1, 16, 64, 512])
def test_shipped_hidden_sizes_take_the_cluster_design(B):
    """Lbx200 (the flagship and kraken's shipped specs) and Lbx100 keep
    w_hh in a cluster, with every cluster of the launch in one wave."""
    for H in (100, 200):
        kind, C, R = _design(B, 128, 2, H)
        assert kind == 'cluster' and C == 8
        assert -(-B // R) * 2 <= WAVE_CLUSTERS[8]
    assert _design(64, 128, 2, 200) == ('cluster', 8, 12)
    assert _design(512, 128, 2, 200) == ('cluster', 8, 76)


@pytest.mark.parametrize('H', [470, 512, 1024])
def test_large_hidden_sizes_take_the_stream_design(H):
    assert _design(64, 128, 2, H) == ('stream',)


def test_every_cluster_design_fits_shared_memory():
    """227 KB per CTA on sm_90, for every H and batch that picks a cluster;
    a cluster of 16 is taken only where 8 cannot hold w_hh."""
    for H in range(1, 1025):
        for B in (1, 9, 64, 512, 4096):
            for D in (1, 2):
                design = _design(B, 128, D, H)
                if design[0] == 'stream':
                    assert _cluster_smem(H, 16, 4) > SMEM_PER_CTA
                    continue
                _, C, R = design
                assert SMEM_PER_CTA == 227 * 1024
                assert _cluster_smem(H, C, R) <= SMEM_PER_CTA
                assert R % 4 == 0 and -(-H // C) * R <= MAX_SLOTS
                assert C == 8 or _cluster_smem(H, 8, 4) > SMEM_PER_CTA


@pytest.mark.parametrize('H', [8, 25, 130, 200, 400, 5])
@pytest.mark.parametrize('C', [8, 16])
def test_cluster_partition_covers_each_unit_once(H, C):
    owned = [u for rank in range(C) for u in _units(H, C, rank)]
    assert sorted(owned) == list(range(H))
    sizes = [len(_units(H, C, rank)) for rank in range(C)]
    assert max(sizes) == -(-H // C) and max(sizes) - min(sizes) <= 1


def test_build_rebuilds_after_a_header_changes(monkeypatch, tmp_path):
    """A library is stale when any source under csrc, a header included,
    is newer than it."""
    import os
    src = tmp_path / 'csrc'
    src.mkdir()
    (src / 'k.cu').write_text('#include "common.cuh"\n')
    (src / 'common.cuh').write_text('\n')
    lib = tmp_path / 'libk.so'
    lib.write_bytes(b'')
    for p, t in ((src / 'k.cu', 100), (src / 'common.cuh', 100), (lib, 200)):
        os.utime(p, (t, t))
    monkeypatch.setattr(build, 'SOURCE_DIR', src)
    assert not build._stale(lib)
    os.utime(src / 'common.cuh', (300, 300))
    assert build._stale(lib)
    assert build._stale(tmp_path / 'missing.so')


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernel has no CPU mode')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('reverse', [False, True])
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, reverse):
    rng = np.random.RandomState(8)
    Bc, Tc, Hc = 9, 33, 40
    g = torch.from_numpy(rng.randn(Bc, Tc, 2, 4 * Hc).astype(np.float32) * 0.5)
    w = torch.from_numpy(rng.randn(2, 4 * Hc, Hc).astype(np.float32) / Hc ** 0.5)
    lens = torch.from_numpy(np.array([33, 1, 16, 5, 33, 20, 2, 31, 9]))
    m = torch.arange(Tc)[None, :] < lens[:, None]
    g, w, m = g.to(cuda_device, dtype), w.to(cuda_device), m.to(cuda_device)
    before = lstm_recurrence.launches
    out = lstm_recurrence(g, w, m, reverse)
    torch.cuda.synchronize()
    assert lstm_recurrence.launches == before + 1
    ref = lstm_recurrence_reference(g, w, m, reverse)
    atol = 1e-5 if dtype == torch.float32 else 2e-2
    assert (out.float() - ref.float()).abs().max().item() <= atol
