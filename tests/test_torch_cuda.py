"""
The port on the card: the CUDA LSTM kernel inside a VGSL forward and the
recognition engine on a CUDA device, held against the plain recurrence on
the same tensors. Every test needs an NVIDIA GPU and skips without one.

This file imports neither JAX nor kraken_tpu, so it also runs where only
torch is installed, without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from kraken_tpu_torch.nn.layers import TransposedSummarizingRNN
from kraken_tpu_torch.ops.lstm import (SMEM_PER_CTA, _cluster_smem, _design, _launch,
                                       cluster_occupancy, lstm_recurrence,
                                       lstm_recurrence_reference)
from kraken_tpu_torch.vgsl import VGSLModel

RESOURCES = Path(__file__).resolve().parent / 'resources'
SPEC = '[1,48,0,1 Cr3,13,8 Mp2,2 Cr3,9,16 Mp2,2 S1(1x0)1,3 Lbx32 Lfx24 O1c20]'


@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernel has no CPU mode')
    # fp32 convolutions in full fp32, as the engine runs them
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
    return torch.device('cuda')


@pytest.mark.cuda
def test_forward_launches_kernel_and_matches_plain(cuda_device):
    model = VGSLModel(SPEC, generator=torch.Generator().manual_seed(0))
    model.net.to(cuda_device)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(5, 1, 48, 96).astype(np.float32)).to(cuda_device)
    lens = torch.tensor([96, 80, 33, 9, 4], dtype=torch.int32, device=cuda_device)
    before = lstm_recurrence.launches
    before_cluster = lstm_recurrence.design_launches['cluster']
    with torch.inference_mode():
        y, olens = model(x, lens)
    torch.cuda.synchronize()
    # one launch per LSTM layer, both directions of the BiLSTM in one, and
    # both hidden sizes take the cluster design
    assert lstm_recurrence.launches == before + 2
    assert lstm_recurrence.design_launches['cluster'] == before_cluster + 2
    rnns = [m for m in model.net.modules() if isinstance(m, TransposedSummarizingRNN)]
    for m in rnns:
        m.recurrence = lstm_recurrence_reference
    with torch.inference_mode():
        y_ref, olens_ref = model(x, lens)
    assert torch.equal(olens, olens_ref)
    assert (y - y_ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize('bad', ['dtype', 'mask_dtype', 'strided', 'devices'])
def test_kernel_wrapper_raises(cuda_device, bad):
    g = torch.zeros(2, 3, 1, 32, device=cuda_device)
    w = torch.zeros(1, 32, 8, device=cuda_device)
    m = torch.ones(2, 3, dtype=torch.bool, device=cuda_device)
    err = ValueError
    if bad == 'dtype':
        g, err = g.double(), TypeError
    elif bad == 'mask_dtype':
        m, err = m.float(), TypeError
    elif bad == 'strided':
        g = torch.zeros(3, 2, 1, 32, device=cuda_device).transpose(0, 1)
    else:
        w = w.cpu()
    with pytest.raises(err):
        lstm_recurrence(g, w, m)


@pytest.mark.cuda
@pytest.mark.parametrize('precision', ['32-true', 'bf16-true'])
def test_engine_on_cuda(cuda_device, precision):
    from PIL import Image
    from kraken_tpu_torch.codec import Codec
    from kraken_tpu_torch.configs import RecognitionInferenceConfig
    from kraken_tpu_torch.containers import BaselineLine, Segmentation
    model = VGSLModel(SPEC, codec=Codec('abcdefghijklmnopqrs'),
                      generator=torch.Generator().manual_seed(1))
    model.model_type = ['recognition']
    model.seg_type = 'baselines'
    model.use_legacy_polygons = False
    model.prepare_for_inference(RecognitionInferenceConfig(
        batch_size=4, num_line_workers=0, precision=precision))
    assert model.device.type == 'cuda'
    seg = Segmentation(type='baselines', imagename=RESOURCES / 'bw.png',
                       text_direction='horizontal-lr', script_detection=False,
                       lines=[BaselineLine(id=f'l{i}', baseline=[[0, 10], [x1, 10]],
                                           boundary=[[0, 0], [x1, 0], [x1, 155], [0, 155]])
                              for i, x1 in enumerate((2543, 1800, 900, 600, 1200))])
    before = lstm_recurrence.launches
    before_cluster = lstm_recurrence.design_launches['cluster']
    records = list(model.predict(Image.open(RESOURCES / '000236.png'), seg))
    assert len(records) == 5
    assert lstm_recurrence.launches == before + 2 * 2  # two batches, two LSTM layers
    assert lstm_recurrence.design_launches['cluster'] == before_cluster + 2 * 2
    assert all(len(r.cuts) == len(r.prediction) for r in records)


def _recurrence_inputs(B, T, H, seed):
    rng = np.random.RandomState(seed)
    g = torch.from_numpy(rng.randn(B, T, 2, 4 * H).astype(np.float32) * 0.5)
    w = torch.from_numpy(rng.randn(2, 4 * H, H).astype(np.float32) / H ** 0.5)
    lens = rng.randint(1, T + 1, size=B)
    lens[:3] = T, 1, T // 2
    m = torch.arange(T)[None, :] < torch.from_numpy(lens)[:, None]
    return g, w, m


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('B,T,H,design', [
    (9, 33, 130, ('cluster', 8, 4)),     # ragged partition: 130 = 6 x 16 + 2 x 17
    (5, 17, 400, ('cluster', 16, 4)),    # w_hh too large for 8 CTAs
    (70, 12, 200, ('cluster', 8, 12)),   # several row groups, a ragged last tile
    (6, 21, 512, ('stream',)),           # w_hh too large for any cluster
])
def test_each_design_matches_plain_version(cuda_device, B, T, H, design, dtype, reverse):
    """Lengths 1, T and mid values, both directions in one launch; the
    launch is counted under the design the shapes pick."""
    assert _design(B, T, 2, H) == design
    g, w, m = _recurrence_inputs(B, T, H, H + B)
    g, w, m = g.to(cuda_device, dtype), w.to(cuda_device), m.to(cuda_device)
    before = dict(lstm_recurrence.design_launches)
    out = lstm_recurrence(g, w, m, reverse)
    torch.cuda.synchronize()
    after = lstm_recurrence.design_launches
    assert after[design[0]] == before[design[0]] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    ref = lstm_recurrence_reference(g, w, m, reverse)
    atol = 1e-5 if dtype == torch.float32 else 2e-2
    assert out.dtype == dtype and out.shape == (B, T, 2, H)
    assert (out.float() - ref.float()).abs().max().item() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize('w_dtype', [torch.bfloat16, torch.float16])
def test_cluster_design_reads_weights_in_their_type(cuda_device, w_dtype):
    """A model cast to bf16/fp16 hands w_hh over in its own type; the
    kernel widens it to fp32 as it loads it, as the plain version does."""
    g, w, m = _recurrence_inputs(7, 25, 200, 3)
    g, w, m = g.to(cuda_device, w_dtype), w.to(cuda_device, w_dtype), m.to(cuda_device)
    out = lstm_recurrence(g, w, m)
    ref = lstm_recurrence_reference(g, w, m)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize('B,H', [(64, 200), (512, 200), (9, 130), (5, 400)])
def test_cluster_shapes_match_their_mirror(cuda_device, B, H):
    """The shared memory that ops/lstm.py plans with is what the kernel
    source asks for, and the card holds every cluster of the launch at once."""
    _, C, R = _design(B, 128, 2, H)
    smem, threads, clusters = cluster_occupancy(H, C, R, cuda_device.index or 0)
    assert smem == _cluster_smem(H, C, R) <= SMEM_PER_CTA
    assert threads % 32 == 0 and threads <= 512
    assert clusters >= -(-B // R) * 2


@pytest.mark.cuda
def test_stream_design_runs_hidden_sizes_a_cluster_holds(cuda_device):
    """The stream design, forced at the flagship hidden size, agrees with the
    cluster design that the shapes pick."""
    g, w, m = _recurrence_inputs(12, 40, 200, 5)
    g, w, m = g.to(cuda_device), w.to(cuda_device), m.to(cuda_device)
    cluster = lstm_recurrence(g, w, m, True)
    stream = _launch(g, w, m, True, ('stream',))
    assert (cluster - stream).abs().max().item() <= 1e-5


# ---------------------------------------------------------------- segmentation
def _within(out: torch.Tensor, ref: torch.Tensor, dtype) -> bool:
    """fp32: within 1e-5. bf16 outputs: within 2e-2 of values up to 1 and
    2e-2 relative above (one bf16 ulp is 2^-8 of the value's binade)."""
    err = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        return err.max().item() <= 1e-5
    return bool((err <= 2e-2 * ref.float().abs().clamp(min=1)).all())


def _group_norm_inputs(shape, dtype, device):
    rng = np.random.RandomState(sum(shape))
    x = torch.from_numpy(np.maximum(rng.randn(*shape), 0).astype(np.float32)).to(device, dtype)
    w = torch.from_numpy((1 + 0.1 * rng.randn(shape[1])).astype(np.float32)).to(device, dtype)
    b = torch.from_numpy((0.1 * rng.randn(shape[1])).astype(np.float32)).to(device, dtype)
    return x, w, b


@pytest.mark.cuda
@pytest.mark.parametrize('forced', [None, 'stream'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape, groups, lens', [
    ((1, 32, 256, 177), 8, None),        # the shipped model's first Gn
    ((1, 96, 128, 89), 16, None),
    ((1, 128, 450, 312), 32, None),      # the full-size spec: 16 CTAs a cluster in fp32
    ((3, 16, 37, 61), 4, [61, 30, 1]),   # ragged lengths, 1 and full
    ((2, 96, 20, 33), 16, [5, 40]),      # a length beyond W is clamped
])
def test_group_norm_kernel_matches_plain(cuda_device, shape, groups, lens, dtype, forced):
    """Each design against the plain version: the one the shapes pick (all
    of these take the cluster design) and the stream design forced; each
    call counts its device launches (1 cluster, 2 stream) under its design."""
    from kraken_tpu_torch.ops.groupnorm import _design, _launch, group_norm, group_norm_reference
    x, w, b = _group_norm_inputs(shape, dtype, cuda_device)
    seq = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    design = ('stream',) if forced else _design(*shape, groups, dtype)
    assert forced or design[0] == 'cluster'

    def run():
        if forced:
            return _launch(x, w, b, groups, 1e-5, seq, design)
        return group_norm(x, w, b, groups, 1e-5, seq)

    before, before_design = group_norm.launches, dict(group_norm.design_launches)
    y = run()
    torch.cuda.synchronize()
    per_call = 1 if design[0] == 'cluster' else 2  # stream: statistics, then merge + normalise
    assert group_norm.launches == before + per_call
    assert group_norm.design_launches[design[0]] == before_design[design[0]] + per_call
    assert sum(group_norm.design_launches.values()) == sum(before_design.values()) + per_call
    ref = group_norm_reference(x, w, b, groups, 1e-5, seq)
    assert y.dtype == dtype and y.shape == x.shape
    assert _within(y, ref, dtype)
    if lens is not None:
        for n, L in enumerate(lens):
            assert not y[n, :, :, min(L, shape[3]):].any()
    # the same call again gives the same bits (fixed merge order, no float atomics)
    assert torch.equal(run(), y)


@pytest.mark.cuda
def test_group_norm_raises_when_the_cluster_launch_is_refused(cuda_device):
    """A cluster shape the card cannot hold (2 CTAs of 362 KB each) raises;
    it does not fall back to the stream design."""
    from kraken_tpu_torch.ops.groupnorm import _launch, group_norm
    x, w, b = _group_norm_inputs((1, 32, 256, 177), torch.float32, cuda_device)
    before = dict(group_norm.design_launches)
    with pytest.raises(RuntimeError, match='cluster'):
        _launch(x, w, b, 8, 1e-5, None, ('cluster', 2, 512))
    assert group_norm.design_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize('shape, groups, dtype', [
    ((1, 32, 256, 177), 8, torch.float32), ((1, 96, 128, 89), 16, torch.bfloat16),
    ((1, 128, 450, 312), 32, torch.float32), ((1, 64, 900, 623), 32, torch.bfloat16)])
def test_group_norm_cluster_shapes_match_their_mirror(cuda_device, shape, groups, dtype):
    """The shared memory that ops/groupnorm.py plans with is what the kernel
    source asks for, and the card holds such clusters."""
    from kraken_tpu_torch.ops.groupnorm import SMEM_PER_CTA, _cluster_smem, _design, cluster_occupancy
    _, CL, R = _design(*shape, groups, dtype)
    smem, threads, clusters = cluster_occupancy(shape[1], *shape[2:], groups, CL, dtype,
                                                cuda_device.index or 0)
    assert smem == _cluster_smem(R, shape[3], dtype) <= SMEM_PER_CTA
    assert threads == 512 and clusters >= 1


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape, out', [
    ((1, 10, 128, 89), (512, 354)),      # the shipped model's head
    ((1, 10, 450, 312), (1800, 1245)),   # the full-size spec's head
    ((2, 3, 13, 9), (50, 31)),           # non-integer ratios
    ((1, 2, 7, 300), (7, 301)),          # OH = h
    ((2, 3, 13, 20), (50, 81)),          # output widths 1, 2, 3 mod 4
    ((1, 3, 9, 30), (37, 354)),
    ((1, 3, 9, 30), (37, 355)),
    ((1, 2, 10, 17), (40, 17)),          # OW = w
    ((1, 1, 16, 3000), (64, 12003)),     # several column chunks a row
    ((1, 2, 40, 30), (40, 4000)),        # OH = h: 17 staged rows a band
])
def test_seg_head_kernel_matches_plain(cuda_device, shape, out, dtype):
    from kraken_tpu_torch.ops.seghead import geometry, seg_head, seg_head_reference
    x = torch.from_numpy(np.random.RandomState(shape[2]).randn(*shape).astype(np.float32) * 4)
    x = x.to(cuda_device, dtype)
    before = seg_head.launches
    y = seg_head(x, *out)
    torch.cuda.synchronize()
    assert seg_head.launches == before + 1
    ref = seg_head_reference(x, *out)
    # the output is fp32 from the same (upcast) inputs whatever the logits'
    # type, and the kernel rounds every step as the plain version does
    assert y.dtype == torch.float32 and (y - ref).abs().max().item() <= 1e-5
    if dtype == torch.float32:
        assert torch.equal(y, ref)
    cw, rows, cols, smem = geometry(*shape[2:], *out)
    assert cw % 4 == 0 and rows <= 17 and smem <= 48 << 10
    with pytest.raises(ValueError, match='only upsamples'):
        seg_head(x, shape[2] - 1, out[1])


@pytest.mark.cuda
@pytest.mark.parametrize('N, K, H, W, channels', [
    (1, 10, 512, 354, (2, 3, 4, 5)),     # the shipped model's baseline channels
    (2, 3, 45, 77, (0, 2)),              # tiles cut by both edges
])
def test_ridge_kernel_matches_plain(cuda_device, N, K, H, W, channels):
    from kraken_tpu_torch.ops.ridge import sato_ridge_reference, sato_ridge_threshold
    rng = np.random.RandomState(H)
    yy = np.arange(H)[:, None]
    maps = np.zeros((N, K, H, W), np.float32)
    for n in range(N):
        for k in range(K):
            for _ in range(6):
                y0, slope = rng.uniform(0, H), rng.uniform(-0.1, 0.1)
                maps[n, k] += np.exp(-0.5 * ((yy - y0 - slope * np.arange(W)[None]) / 3.0) ** 2)
    probs = torch.from_numpy(np.clip(maps + 0.05 * rng.rand(*maps.shape), 0, 1)
                             .astype(np.float32)).to(cuda_device)
    response = torch.empty((N, len(channels), H, W), device=cuda_device)
    before = sato_ridge_threshold.launches
    mask = sato_ridge_threshold(probs, channels, 0.17, response)
    torch.cuda.synchronize()
    assert sato_ridge_threshold.launches == before + 1
    ref = sato_ridge_reference(probs[:, list(channels)].reshape(-1, H, W)).reshape(response.shape)
    assert (response - ref).abs().max().item() <= 1e-5
    differ = mask.bool() != (ref > 0.17)
    assert ((ref[differ] - 0.17).abs() <= 1e-5).all()
    assert bool((ref > 0.17).any())


@pytest.mark.cuda
@pytest.mark.parametrize('precision', ['32-true', 'bf16-true'])
def test_segmentation_main_path_launches(cuda_device, precision):
    """The shipped model on the fixture page: 5 GroupNorm layers (one
    cluster launch each), 1 head and 1 ridge launch per page, through
    SegmentationTaskModel on the card."""
    from PIL import Image
    from kraken_tpu_torch import native
    from kraken_tpu_torch.configs import SegmentationInferenceConfig
    from kraken_tpu_torch.ops.groupnorm import group_norm
    from kraken_tpu_torch.ops.ridge import sato_ridge_threshold
    from kraken_tpu_torch.ops.seghead import seg_head
    from kraken_tpu_torch.tasks import SegmentationTaskModel
    task = SegmentationTaskModel.load_model()
    im = Image.open(RESOURCES / '170025120000003,0074.jpg')
    before = (group_norm.launches, seg_head.launches, sato_ridge_threshold.launches)
    before_cluster = group_norm.design_launches['cluster']
    seg = task.predict(im, SegmentationInferenceConfig(precision=precision))
    after = (group_norm.launches, seg_head.launches, sato_ridge_threshold.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (5, 1, 1)
    assert group_norm.design_launches['cluster'] == before_cluster + 5
    assert native.available()
    assert len(seg.lines) > 30 and all(len(line.boundary) >= 3 for line in seg.lines)
