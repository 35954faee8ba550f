"""
The port on the card: the CUDA LSTM kernel inside a VGSL forward and the
recognition engine on a CUDA device, held against the plain recurrence on
the same tensors. Every test needs an NVIDIA GPU and skips without one.

This file imports neither JAX nor kraken_tpu, so it also runs where only
torch is installed, without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""
import importlib.util
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


def _smoke():
    """chip_smoke.py, whose case lists (the routes' edges) these tests share."""
    spec = importlib.util.spec_from_file_location('chip_smoke', RESOURCES.parents[1] / 'chip_smoke.py')
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = _smoke()
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


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('B,T,H', [(3, 7, 8), (7, 33, 25), (9, 20, 130), (5, 17, 400),
                                   (5, 17, 512), (6, 40, 100)])
def test_peephole_variant_matches_plain_version(cuda_device, B, T, H, dtype, reverse):
    """The ocropy cell (csrc/lstm.cu's peephole flag) in the design the
    shapes pick (cluster of 8 or 16, or stream at H = 512), ragged masks and
    random peephole weights; each launch counted once as peephole and once
    under its design."""
    design = _design(B, T, 2, H)
    g, w, m = _recurrence_inputs(B, T, H, H + B + 1)
    p = torch.from_numpy(np.random.RandomState(H).randn(2, 3, H).astype(np.float32))
    g, w, m, p = g.to(cuda_device, dtype), w.to(cuda_device), m.to(cuda_device), p.to(cuda_device)
    before = dict(lstm_recurrence.design_launches), lstm_recurrence.peephole_launches
    out = lstm_recurrence(g, w, m, reverse, peephole=p)
    torch.cuda.synchronize()
    assert lstm_recurrence.peephole_launches == before[1] + 1
    assert lstm_recurrence.design_launches[design[0]] == before[0][design[0]] + 1
    ref = lstm_recurrence_reference(g, w, m, reverse, peephole=p)
    atol = 1e-5 if dtype == torch.float32 else 2e-2
    assert out.dtype == dtype and out.shape == (B, T, 2, H)
    assert (out.float() - ref.float()).abs().max().item() <= atol
    assert (out.float() - lstm_recurrence_reference(g, w, m, reverse).float()).abs().max() > atol


@pytest.mark.cuda
def test_peephole_wrapper_raises(cuda_device):
    g = torch.zeros(2, 3, 2, 32, device=cuda_device)
    w = torch.zeros(2, 32, 8, device=cuda_device)
    m = torch.ones(2, 3, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError):
        lstm_recurrence(g, w, m, peephole=torch.zeros(2, 3, 8))
    with pytest.raises(ValueError):
        lstm_recurrence(g, w, m, peephole=torch.zeros(2, 2, 8, device=cuda_device))
    with pytest.raises(TypeError):
        lstm_recurrence(g, w, m, peephole=torch.zeros(2, 3, 8, dtype=torch.int32,
                                                      device=cuda_device))


@pytest.mark.cuda
def test_ocropy_forward_launches_peephole_kernel(cuda_device):
    """An Lbxo network: one peephole launch a layer over the whole padded
    width, logits within 1e-4 of the plain recurrence."""
    model = VGSLModel('[1,48,0,1 Cr3,3,8 Mp2,2 S1(1x0)1,3 Lbxo32 Lbxso24 O1c20]',
                      generator=torch.Generator().manual_seed(2))
    rnns = [m for m in model.net.modules() if isinstance(m, TransposedSummarizingRNN)]
    with torch.no_grad():
        for m in rnns:
            for k, v in m.layer.named_parameters():
                if k.startswith(('weight_ip', 'weight_fp', 'weight_op')):
                    v.normal_(0, 0.5, generator=torch.Generator().manual_seed(len(k)))
    model.net.to(cuda_device)
    x = torch.from_numpy(np.random.RandomState(2).rand(5, 1, 48, 96).astype(np.float32))
    lens = torch.tensor([96, 80, 33, 9, 4], dtype=torch.int32)
    x, lens = x.to(cuda_device), lens.to(cuda_device)
    before = lstm_recurrence.peephole_launches
    with torch.inference_mode():
        y, olens = model(x, lens)
    torch.cuda.synchronize()
    assert lstm_recurrence.peephole_launches == before + 2
    for m in rnns:
        m.recurrence = lstm_recurrence_reference
    with torch.inference_mode():
        y_ref, olens_ref = model(x, lens)
    assert torch.equal(olens, olens_ref) and y.shape == (5, 20, 1, 1)
    assert (y - y_ref).abs().max().item() <= 1e-4


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
    (1, 2, 40, 127, (0, 1)),             # W one below, at and one above the 128-wide tile
    (1, 2, 41, 128, (1,)),
    (1, 2, 42, 129, (0, 1)),
    (1, 2, 20, 1245, (0, 1)),            # the full-size width: 10 tiles, the last 93 wide
    (1, 2, 15, 200, (0, 1)),             # H one below, at and one above the 16-row tile
    (1, 2, 16, 200, (0, 1)),
    (1, 2, 17, 200, (0, 1)),
    (1, 2, 7, 300, (0, 1)),              # maps thinner than one tile and than the largest radius
    (1, 2, 300, 7, (0, 1)),
    (2, 5, 64, 150, (1, 3)),             # two pages, a channel subset
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
@pytest.mark.parametrize('N, nc, H, W', [
    (1, 4, 512, 354), (1, 4, 1800, 1245), (2, 3, 45, 77), (1, 2, 7, 300), (1, 2, 300, 7),
    (3, 32, 17, 129)])
def test_ridge_geometry_matches_its_mirror(cuda_device, N, nc, H, W):
    """The launch that ops/ridge.py plans with is what the kernel source
    computes, and its shared memory fits two blocks an SM."""
    from kraken_tpu_torch.ops.ridge import geometry, plan
    assert geometry(N, nc, H, W) == plan(N, nc, H, W)
    props = torch.cuda.get_device_properties(cuda_device)
    smem = plan(N, nc, H, W)[3]
    assert 2 * (smem + 1024) <= props.shared_memory_per_multiprocessor


@pytest.mark.cuda
def test_ridge_raises_when_the_launch_is_refused(cuda_device):
    """More than 65535 planes: the kernel refuses the launch, the wrapper
    raises and counts nothing; it does not fall back to the plain version."""
    from kraken_tpu_torch.ops.ridge import sato_ridge_threshold
    probs = torch.zeros((65536, 1, 1, 1), device=cuda_device)
    before = sato_ridge_threshold.launches
    with pytest.raises(RuntimeError, match='launch failed'):
        sato_ridge_threshold(probs, (0,), 0.17)
    assert sato_ridge_threshold.launches == before


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


def tail_tie_logits(N: int, C: int, W: int, seed: int) -> np.ndarray:
    """Seeded logits with exact ties, as tests/test_torch_tail.py:logits
    makes them: a frame of equal logits, two equal maxima, a maximum
    repeated at the last class."""
    x = np.random.default_rng(seed).normal(0, 4, (N, C, 1, W)).astype(np.float32)
    x[0, :, 0, 0] = 1.5
    x[0, 3, 0, 1] = x[0, 7 % C, 0, 1] = x[0, :, 0, 1].max() + 1
    x[-1, C - 1, 0, -1] = x[-1, 0, 0, -1] = x[-1, :, 0, -1].max() + 2
    return x


def tail_layout(x: torch.Tensor, layout: str) -> torch.Tensor:
    """The contiguous (N, C, 1, W) logits `x` with the same values as the
    network leaves them (a view of (N, W, C)), contiguous, or either of
    them sliced along W (every other frame of a buffer twice as wide)."""
    N, C, _, W = x.shape
    step = 2 if layout.endswith('sliced') else 1
    if layout.startswith('frames'):
        buf = x.new_zeros((N, step * W, C))
        buf[:, ::step] = x[:, :, 0].transpose(1, 2)
        y = buf.transpose(1, 2).unsqueeze(2)
    else:
        y = x.new_zeros((N, C, 1, step * W))
        y[..., ::step] = x
    return y[..., ::step]


@pytest.mark.cuda
@pytest.mark.parametrize('layout', ['frames', 'contiguous', 'frames_sliced', 'contiguous_sliced'])
@pytest.mark.parametrize('with_probs', [True, False])
@pytest.mark.parametrize('temperature', [1.0, 0.7])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize('N, C, W, ties', [
    (1, 2, 1, False), (1, 250, 31, False), (64, 2, 33, False), (64, 250, 128, False),
    (64, 250, 1, False),     # W = 1 with N = 64
    (4, 250, 100, False),    # W not a multiple of the 32-frame tile
    (3, 1, 45, False), (5, 33, 70, False), (4, 97, 100, False),
    (3, 1000, 77, False),    # 16-frame tiles, W not a multiple of 16
    (2, 4000, 45, False),    # the direct route (a warp a frame from device memory)
    (2, 20, 33, True), (4, 250, 128, True), (2, 4000, 9, True)])  # exact ties
def test_recognition_tail_kernel_matches_plain(cuda_device, N, C, W, ties, dtype, temperature,
                                               with_probs, layout):
    """The tail kernel against its plain version on the same logits, laid
    out as the network leaves them (a view of (N, W, C)), contiguous or
    sliced along W: probabilities and confidences within 1e-6 (both sum in
    fp64, in another order), labels equal except where the plain version's
    top two probabilities are within 1e-6 relative of each other (a
    near-tie); on logits with exact ties every label equal (the first
    maximal class wins)."""
    from kraken_tpu_torch.ops.tail import recognition_tail, recognition_tail_reference
    if ties:
        x = torch.from_numpy(tail_tie_logits(N, C, W, seed=N * 1000 + W)).to(cuda_device, dtype)
    else:
        gen = torch.Generator(device=cuda_device).manual_seed(N * C + W)
        x = (4 * torch.randn(N, C, 1, W, generator=gen, device=cuda_device)).to(dtype)
    x = tail_layout(x, layout)
    before = recognition_tail.launches
    probs, labels, confs = recognition_tail(x, temperature, probs=with_probs)
    torch.cuda.synchronize()
    assert recognition_tail.launches == before + 1
    ref_probs, ref_labels, ref_confs = recognition_tail_reference(x, temperature)
    assert labels.dtype == torch.int64 and confs.dtype == torch.float32
    assert (confs - ref_confs).abs().max().item() <= 1e-6
    if with_probs:
        assert (probs - ref_probs).abs().max().item() <= 1e-6
    else:
        assert probs is None
    top = ref_probs.topk(min(2, C), dim=1).values
    near_tie = (top[:, 0] - top[:, -1]) <= 1e-6 * top[:, 0] if C > 1 and not ties else \
        torch.zeros_like(ref_labels, dtype=torch.bool)
    assert torch.equal(labels[~near_tie], ref_labels[~near_tie])


@pytest.mark.cuda
@pytest.mark.parametrize('N, C, W', [
    (64, 250, 128), (16, 250, 800), (64, 250, 1), (3, 1, 45), (3, 903, 40), (3, 904, 40),
    (3, 1807, 17), (3, 1808, 17), (2, 3615, 9), (2, 3616, 9), (2, 4000, 45), (1, 20000, 3)])
def test_tail_geometry_matches_its_mirror(cuda_device, N, C, W):
    """The launch that ops/tail.py plans with is what the kernel source
    computes, and a tile's shared memory leaves room for two blocks an SM."""
    from kraken_tpu_torch.ops.tail import geometry, plan
    assert geometry(N, C, W) == plan(N, C, W)
    props = torch.cuda.get_device_properties(cuda_device)
    assert 2 * (plan(N, C, W)[3] + 1024) <= props.shared_memory_per_multiprocessor


@pytest.mark.cuda
@pytest.mark.parametrize('bad', ['dtype', 'shape', 'temperature'])
def test_recognition_tail_wrapper_raises(cuda_device, bad):
    from kraken_tpu_torch.ops.tail import recognition_tail
    x = torch.randn(2, 5, 1, 7, device=cuda_device)
    if bad == 'dtype':
        x = x.double()
    elif bad == 'shape':
        x = torch.randn(2, 5, 2, 7, device=cuda_device)
    with pytest.raises((TypeError, ValueError)):
        recognition_tail(x, 0.0 if bad == 'temperature' else 1.0)


def trellis_lines(seed: int, shapes) -> list:
    """(emission, tokens) per (T, L, C): log-softmax of random softmax
    outputs, as the alignment task builds them, tokens in [1, C)."""
    rng = np.random.RandomState(seed)
    lines = []
    for T, L, C in shapes:
        probs = rng.dirichlet(np.ones(C) * 0.3, size=T).astype(np.float32).T
        shifted = probs - probs.max(axis=0, keepdims=True)
        emission = (shifted - np.log(np.exp(shifted).sum(axis=0, keepdims=True))).T
        lines.append((np.ascontiguousarray(emission), rng.randint(1, C, size=L)))
    return lines


@pytest.mark.cuda
@pytest.mark.parametrize('shapes', [
    [(1, 1, 7), (40, 1, 3), (16, 8, 50), (3, 5, 9), (300, 150, 300)],
    [(2100, 1030, 6), (9, 2, 11)],     # 2 columns a thread
    [(4100, 2047, 4), (5, 1, 2)],      # 2048 columns, the most a block takes
    [(128, 50, 250)] * 64,             # flagship-like
], ids=['ragged', 'cols2', 'cols_max', 'flagship'])
def test_trellis_kernel_equals_plain(cuda_device, shapes):
    from kraken_tpu_torch.align import get_trellis
    from kraken_tpu_torch.ops.trellis import blocks, pad, trellis, trellis_reference
    lines = trellis_lines(len(shapes), shapes)
    args = pad([e for e, _ in lines], [t for _, t in lines], 'cpu')
    frames, lens = args[2].tolist(), args[3].tolist()
    before = trellis.launches
    out = trellis(*[a.to(cuda_device) for a in args])
    torch.cuda.synchronize()
    assert trellis.launches == before + 1
    ref = trellis_reference(*args)
    for (e, t), a, b in zip(lines, blocks(out.cpu(), frames, lens), blocks(ref, frames, lens)):
        assert torch.equal(a, b)
        if e.shape[0] <= 300:
            assert np.array_equal(a.numpy(), get_trellis(e, t))


@pytest.mark.cuda
@pytest.mark.parametrize('cols', SMOKE.TRELLIS_COLUMNS)
def test_trellis_routes_equal_plain(cuda_device, cols):
    """Each route that takes the batch (warp up to 256 columns, block up to
    2,048, long any) against the plain version and numpy, bit for bit, and
    the auto route the plan's, counted on it."""
    from kraken_tpu_torch.align import get_trellis
    from kraken_tpu_torch.ops.trellis import (ROUTES, _launch, blocks, pad, plan, trellis,
                                              trellis_reference)
    L = cols - 1
    lines = trellis_lines(cols, [(2 * L + 3, L, 40), (0, 3, 40), (1, 1, 40), (5, 9, 40)])
    args = pad([e for e, _ in lines], [t for _, t in lines], 'cpu')
    frames, lens = args[2].tolist(), args[3].tolist()
    ref = trellis_reference(*args)
    route = plan(*args[1].shape, args[0].shape[2])[0]
    assert route == ('warp' if cols <= 256 else 'block')
    before = dict(trellis.route_launches)
    trellis(*[a.to(cuda_device) for a in args])
    assert trellis.route_launches == {**before, route: before[route] + 1}
    for r in ROUTES[ROUTES.index(route):]:
        out = _launch(*[a.to(cuda_device) for a in args], r).cpu()
        for (e, t), a, b in zip(lines, blocks(out, frames, lens), blocks(ref, frames, lens)):
            assert torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
            assert np.array_equal(a.numpy(), get_trellis(e, t)), r


@pytest.mark.cuda
def test_trellis_warp_route_mixed_batch(cuda_device):
    """Short lines (no frame, one, more tokens than frames) padded beside a
    255-token line, the warp route's longest (K = 8), bit for bit."""
    from kraken_tpu_torch.align import get_trellis
    from kraken_tpu_torch.ops.trellis import blocks, pad, plan, trellis
    lines = trellis_lines(11, SMOKE.TRELLIS_MIXED)
    args = pad([e for e, _ in lines], [t for _, t in lines], cuda_device)
    assert plan(*args[1].shape, args[0].shape[2])[:2] == ('warp', 8)
    out = trellis(*args).cpu()
    for (e, t), a in zip(lines, blocks(out, args[2].tolist(), args[3].tolist())):
        assert np.array_equal(a.numpy(), get_trellis(e, t))


@pytest.mark.cuda
@pytest.mark.parametrize('N, L_max, C', [(44, 89, 36), (64, 64, 250), (1, 31, 2), (5, 32, 40),
                                         (7, 255, 453), (7, 255, 454), (7, 255, 1815),
                                         (7, 255, 1816), (9, 256, 40),
                                         (3, 1023, 9), (3, 1024, 9), (2, 2047, 4), (2, 2048, 4),
                                         (4, 3000, 40)])
def test_trellis_geometry_matches_its_plan(cuda_device, N, L_max, C):
    from kraken_tpu_torch.ops.trellis import geometry, plan
    assert geometry(N, L_max, C, cuda_device.index or 0) == plan(N, L_max, C)


@pytest.mark.cuda
def test_trellis_route_refuses_a_line_too_long(cuda_device):
    from kraken_tpu_torch.ops.trellis import _launch
    args = [torch.zeros(1, 4, 5, device=cuda_device),
            torch.ones(1, 256, dtype=torch.int32, device=cuda_device),
            torch.tensor([4], dtype=torch.int32, device=cuda_device),
            torch.tensor([256], dtype=torch.int32, device=cuda_device)]
    with pytest.raises(RuntimeError):
        _launch(*args, 'warp')


@pytest.mark.cuda
@pytest.mark.parametrize('bad', ['nan', 'token_high', 'frames_over', 'no_tokens', 'strided',
                                 'devices'])
def test_trellis_wrapper_raises(cuda_device, bad):
    """Layouts are refused before the launch; counts, tokens and emissions
    by the kernel, which writes nothing for the line (a launch)."""
    from kraken_tpu_torch.ops.trellis import trellis
    e = torch.zeros(2, 6, 5, device=cuda_device)
    t = torch.ones(2, 3, dtype=torch.int32, device=cuda_device)
    fl = torch.full((2,), 6, dtype=torch.int32, device=cuda_device)
    tl = torch.full((2,), 3, dtype=torch.int32, device=cuda_device)
    launched = 1
    if bad == 'nan':
        e[1, 2, 0] = float('nan')
    elif bad == 'token_high':
        t[0, 2] = 5
    elif bad == 'frames_over':
        fl[1] = 7
    elif bad == 'no_tokens':
        tl[0] = 0
    else:
        launched = 0
        if bad == 'strided':
            e = torch.zeros(6, 2, 5, device=cuda_device).transpose(0, 1)
        else:
            fl = fl.cpu()
    before = trellis.launches
    with pytest.raises(ValueError):
        trellis(e, t, fl, tl)
    assert trellis.launches == before + launched


@pytest.mark.cuda
def test_trellis_wrapper_takes_a_long_line(cuda_device):
    """A line of more than 2047 tokens (2048 columns a block at 2 a thread)
    takes the kernel's long route: a 4096-frame line of 3000 tokens padded
    in a batch with short lines, each line bit for bit the plain version's
    and numpy's get_trellis, in one launch."""
    from kraken_tpu_torch.align import get_trellis
    from kraken_tpu_torch.ops.trellis import blocks, pad, trellis, trellis_reference
    lines = trellis_lines(7, [(4096, 3000, 40), (12, 5, 40), (300, 100, 7), (1, 1, 3)])
    args = pad([e for e, _ in lines], [t for _, t in lines], 'cpu')
    frames, lens = args[2].tolist(), args[3].tolist()
    before = trellis.launches
    out = trellis(*[a.to(cuda_device) for a in args])
    torch.cuda.synchronize()
    assert trellis.launches == before + 1
    ref = trellis_reference(*args)
    for (e, t), a, b in zip(lines, blocks(out.cpu(), frames, lens), blocks(ref, frames, lens)):
        assert torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
        assert np.array_equal(a.numpy(), get_trellis(e, t))


def long_line_page(seed: int):
    """A 25,700 x 100 page, three short lines and one line 25,600 px wide
    (6,202 frames of the overfit_bl recognizer, which takes 30-px lines;
    the alignment needs 2 a token) with a transcription of 3,000 of the
    model's characters."""
    from PIL import Image
    from kraken_tpu_torch.containers import BaselineLine, Segmentation
    from kraken_tpu_torch.models import load_models
    rng = np.random.RandomState(seed)
    im = Image.fromarray((rng.rand(100, 25700) * 255).astype(np.uint8))
    chars = sorted(c for c in load_models(RESOURCES / 'overfit_bl.safetensors')[0].codec.c2l
                   if len(c) == 1 and not c.isspace())

    def line(i, x0, x1, y0, n):
        return BaselineLine(id=f'l{i}', baseline=[[x0, y0 + 25], [x1, y0 + 25]],
                            boundary=[[x0, y0], [x1, y0], [x1, y0 + 30], [x0, y0 + 30]],
                            text=''.join(rng.choice(chars, n)))
    short = [line(0, 0, 600, 0, 20), line(1, 700, 1300, 0, 40), line(2, 1400, 2200, 0, 50)]
    long = line(3, 0, 25600, 50, 3000)
    seg = lambda lines: Segmentation(type='baselines', imagename='long.png',  # noqa: E731
                                     text_direction='horizontal-lr', script_detection=False,
                                     lines=lines)
    return im, seg(short), seg(short + [long])


@pytest.mark.cuda
def test_alignment_of_a_line_over_2047_tokens(cuda_device):
    """A page with a line of 3,000 tokens aligns on the card in one trellis
    launch: every line's record is what numpy's get_trellis and the
    backtrack give on the emissions the task built, and the page's other
    lines are aligned as on the page without the long line."""
    from kraken_tpu_torch.align import backtrack, get_trellis, merge_repeats
    from kraken_tpu_torch.configs import RecognitionInferenceConfig
    from kraken_tpu_torch.lib.bidi import get_display
    from kraken_tpu_torch.ops.trellis import trellis
    from kraken_tpu_torch.tasks import ForcedAlignmentTaskModel
    from kraken_tpu_torch.tasks import align as align_task
    im, short, page = long_line_page(0)
    task = ForcedAlignmentTaskModel.load_model(RESOURCES / 'overfit_bl.safetensors')
    batches = []
    batch_fn = align_task.get_trellis_batch

    def recorded(emissions, tokens, device):
        batches.append((emissions, tokens))
        return batch_fn(emissions, tokens, device)

    align_task.get_trellis_batch = recorded
    try:
        before = trellis.launches
        aligned = task.predict(im, page, RecognitionInferenceConfig())
        assert trellis.launches == before + 1
        alone = task.predict(im, short, RecognitionInferenceConfig())
    finally:
        align_task.get_trellis_batch = batch_fn
    emissions, tokens = batches[0]
    assert len(emissions) == 4 and max(len(t) for t in tokens) == 3000
    for record, e, t in zip(aligned.lines, emissions, tokens):
        segments = merge_repeats(backtrack(get_trellis(e, t), e, t), get_display(record.text))
        assert record.prediction == ''.join(s.label for s in segments)
        assert record.confidences == [s.score for s in segments]
    assert len(aligned.lines[3].prediction) == 3000
    for a, b in zip(aligned.lines[:3], alone.lines):
        assert (a.prediction, a.cuts, a.confidences) == (b.prediction, b.cuts, b.confidences)


@pytest.mark.cuda
def test_trellis_kernel_reads_only_the_blank_and_the_tokens(cuda_device):
    from kraken_tpu_torch.ops.trellis import trellis, trellis_reference
    e = torch.zeros(1, 6, 5)
    e[0, :, 2] = float('nan')
    e[0, :, 4] = float('inf')
    args = [e, torch.tensor([[1, 3]], dtype=torch.int32), torch.tensor([6], dtype=torch.int32),
            torch.tensor([2], dtype=torch.int32)]
    out = trellis(*[a.to(cuda_device) for a in args]).cpu()
    assert torch.equal(out, trellis_reference(*args))


@pytest.mark.cuda
def test_alignment_on_the_card_equals_the_cpu(cuda_device):
    """The fixture page's transcriptions aligned through overfit_bl on the
    card and on the CPU: the same records, one trellis launch a predict, on
    the warp route."""
    import json
    from PIL import Image
    from kraken_tpu_torch.configs import RecognitionInferenceConfig
    from kraken_tpu_torch.containers import Segmentation
    from kraken_tpu_torch.ops.trellis import trellis
    from kraken_tpu_torch.tasks import ForcedAlignmentTaskModel
    page = json.loads((RESOURCES / 'torch_align_page.json').read_text(encoding='utf-8'))
    im = Image.open(RESOURCES / '170025120000003,0074.jpg')
    task = ForcedAlignmentTaskModel.load_model(RESOURCES / 'overfit_bl.safetensors')
    before = trellis.launches
    routes = dict(trellis.route_launches)
    card = task.predict(im, Segmentation(**page), RecognitionInferenceConfig())
    assert trellis.launches == before + 1 and task.net.device.type == 'cuda'
    assert trellis.route_launches == {**routes, 'warp': routes['warp'] + 1}
    cpu = task.predict(im, Segmentation(**page), RecognitionInferenceConfig(device='cpu'))
    assert trellis.launches == before + 1
    assert sum(bool(r.prediction) for r in card.lines) > 40
    for a, b in zip(card.lines, cpu.lines):
        assert (a.prediction, a.cuts) == (b.prediction, b.cuts)
        np.testing.assert_allclose(a.confidences, b.confidences, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_reading_order_on_the_card_equals_the_golden(cuda_device):
    """The fixture page through the shipped segmenter and the reading-order
    fixture on the card: the reading-order model on the card, the JAX
    package's line orders and pair probabilities (within 1e-6)."""
    import json
    from PIL import Image
    from kraken_tpu_torch.configs import SegmentationInferenceConfig
    from kraken_tpu_torch.lib.geometry import pair_probabilities
    from kraken_tpu_torch.models import load_models
    from kraken_tpu_torch.tasks import SegmentationTaskModel
    golden = json.loads((RESOURCES / 'torch_ro_golden.json').read_text())
    task = SegmentationTaskModel(load_models(RESOURCES / 'blla_small.safetensors')
                                 + load_models(RESOURCES / 'ro_small.safetensors'))
    im = Image.open(RESOURCES / '170025120000003,0074.jpg')
    seg = task.predict(im, SegmentationInferenceConfig())
    ro = task.ro_models[0]
    assert ro.device.type == 'cuda'
    assert seg.line_orders == golden['line_orders']
    probs = pair_probabilities(seg.lines, im.size, ro, ro.class_mapping)
    np.testing.assert_allclose(probs, golden['pair_probabilities'], rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize('shape, r', [((1, 41, 37), 20), ((3, 40, 64), 20), ((1, 9, 5), 20),
                                      ((3, 1, 30), 7), ((2, 64, 1), 33), ((1, 130, 70), 1),
                                      ((3, 33, 33), 33), ((1, 5, 7), 1800)],
                         ids=['odd', 'even_N3', 'narrow', 'one_row', 'one_col', 'r1',
                              'r33', 'direct'])
def test_percentile_kernel_equals_plain(cuda_device, shape, r):
    """The sliding-window percentile kernel against its plain version, bit
    for bit, in both window shapes, on maps narrower than the pad and on
    the direct route (a window larger than a block's shared memory)."""
    from kraken_tpu_torch.ops.binarize import window_percentile, window_percentile_reference
    rng = np.random.RandomState(r)
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32))
    x.view(-1)[::3] = x.view(-1)[0]  # ties
    for size in ((r, 2), (2, r)):
        before = window_percentile.launches
        out = window_percentile(x.to(cuda_device), 80, size)
        torch.cuda.synchronize()
        assert window_percentile.launches == before + 1
        ref = window_percentile_reference(x, 80, size)
        assert torch.equal(out.cpu().view(torch.int32), ref.view(torch.int32)), size


@pytest.mark.cuda
@pytest.mark.parametrize('size, route', [((20, 2), 'sliding'), ((2, 20), 'sliding'),
                                         ((33, 2), 'sliding'), ((877, 2), 'sliding'),
                                         ((878, 2), 'staged'), ((1700, 2), 'staged'),
                                         ((3, 3), 'staged'), ((1800, 2), 'direct'),
                                         ((2, 7000), 'direct')])
def test_percentile_geometry(cuda_device, size, route):
    """The kernel's route on an H100: the sliding runs of a window with a
    side of 1 or 2 where one warp's strip and runs fit a block's opt-in
    shared memory (232,448 bytes); else its 32 x 8 output tile and reflect
    halo in shared memory, or from device memory when they exceed it."""
    from kraken_tpu_torch.ops.binarize import TILE, geometry
    got, tile, tiles, smem, _ = geometry(2, 50, 60, size, cuda_device.index or 0)
    assert got == route
    if route == 'staged':
        assert (tile, tiles, smem) == (TILE, 1, (8 + size[0] - 1) * (32 + size[1] - 1) * 4)
    elif route == 'direct':
        assert (tile, tiles, smem) == (TILE, 1, 0)


@pytest.mark.cuda
@pytest.mark.parametrize('N, H, W, size', [
    (1, 1982, 1371, (20, 2)), (1, 1982, 1371, (2, 20)), (3, 40, 64, (20, 2)), (1, 9, 5, (877, 2)),
    (1, 9, 5, (2, 878)), (1, 40, 70, (207, 2)), (1, 40, 70, (2, 208)), (2, 33, 95, (1, 1)),
    (3, 33, 33, (3, 33)), (1, 5, 7, (1800, 2)), (1, 5, 7, (2, 1800))])
def test_percentile_geometry_matches_its_plan(cuda_device, N, H, W, size):
    from kraken_tpu_torch.ops.binarize import geometry, plan
    assert geometry(N, H, W, size, cuda_device.index or 0) == plan(N, H, W, size)


@pytest.mark.cuda
@pytest.mark.parametrize('shape, r, values', SMOKE.PERCENTILE_EDGES
                         + [((2, 130, 70), 1, 'uniform'), ((1, 300, 257), 20, 'uniform')],
                         ids=lambda v: str(v).replace(' ', ''))
def test_percentile_routes_equal_plain(cuda_device, shape, r, values):
    """Every route that takes a window, against the plain version, in both
    window shapes: bit for bit, but on the signed-zero map, which is held
    with torch.equal (-0.0 == +0.0: where they tie a route may return
    either zero); and each launch counted on its route."""
    from kraken_tpu_torch.ops.binarize import (SMEM_OPTIN, _launch, plan, window_percentile,
                                               window_percentile_reference)
    x = torch.from_numpy(SMOKE.edge_map(shape, r, values))
    for size in ((r, 2), (2, r)):
        ref = window_percentile_reference(x, 80, size)
        routes = (['sliding'] if plan(*shape, size)[0] == 'sliding' else []) \
            + (['staged'] if (7 + size[0]) * (31 + size[1]) * 4 <= SMEM_OPTIN else []) + ['direct']
        for route in routes:
            before = dict(window_percentile.route_launches)
            out = _launch(x.to(cuda_device), 80, size, route).cpu()
            assert window_percentile.route_launches[route] == before[route] + 1
            if values == 'zeros':
                assert torch.equal(out, ref), (size, route)
            else:
                assert torch.equal(out.view(torch.int32), ref.view(torch.int32)), (size, route)


@pytest.mark.cuda
def test_percentile_sliding_route_refuses_what_it_cannot_take(cuda_device):
    from kraken_tpu_torch.ops.binarize import _launch
    x = torch.rand(1, 9, 5, device=cuda_device)
    for size in ((3, 3), (878, 2)):
        with pytest.raises(RuntimeError):
            _launch(x, 80, size, 'sliding')


@pytest.mark.cuda
@pytest.mark.parametrize('bad', ['nan', 'strided', 'dtype', 'window'])
def test_percentile_wrapper_raises(cuda_device, bad):
    """Layouts are refused before the launch; a NaN by the kernel (a
    launch)."""
    from kraken_tpu_torch.ops.binarize import window_percentile
    x = torch.rand(2, 9, 8, device=cuda_device)
    size, launched = (20, 2), 0
    if bad == 'nan':
        x[1, 3, 4] = float('nan')
        launched = 1
    elif bad == 'strided':
        x = torch.rand(2, 8, 9, device=cuda_device).transpose(1, 2)
    elif bad == 'dtype':
        x = x.half()
    else:
        size = (2, 0)
    before = window_percentile.launches
    with pytest.raises((TypeError, ValueError)):
        window_percentile(x, 80, size)
    assert window_percentile.launches == before + launched


@pytest.mark.cuda
def test_nlbin_device_on_the_card_equals_the_cpu(cuda_device):
    """nlbin of input.jpg on the card (two percentile launches, both on the
    sliding route) against the same call on the CPU: equal but where the
    flattened page lies within 1e-5 of the threshold."""
    from PIL import Image
    from kraken_tpu_torch.ops.binarize import _nlbin_flat, nlbin_device, window_percentile
    arr = np.asarray(Image.open(RESOURCES / 'input.jpg').convert('L'))
    before = window_percentile.launches
    routes = dict(window_percentile.route_launches)
    card = nlbin_device(arr)
    assert card.device.type == 'cuda' and window_percentile.launches == before + 2
    assert window_percentile.route_launches == {**routes, 'sliding': routes['sliding'] + 2}
    flat = _nlbin_flat(torch.from_numpy(arr.astype(np.float32))[None] / 255.0)[0]
    cpu = flat > 0.5
    near = (flat - 0.5).abs() <= 1e-5
    assert not ((card.cpu() != cpu) & ~near).any()


def _ketos_report(args: list) -> str:
    from click.testing import CliRunner
    from kraken_tpu_torch.ketos import cli
    result = CliRunner().invoke(cli, [str(a) for a in args])
    assert result.exit_code == 0, (result.output, result.exception)
    return result.output


@pytest.mark.cuda
@pytest.mark.parametrize('inputs', [[str(p) for p in SMOKE.KETOS_PATH_LINES],
                                    ['-f', 'binary', str(SMOKE.KETOS_ARROW)]],
                         ids=['path', 'binary'])
def test_ketos_test_on_the_card_equals_the_cpu(cuda_device, inputs):
    """``ketos test`` on the card: the report of ``-d cpu``, byte for byte,
    the LSTM kernel and the tail launched."""
    from kraken_tpu_torch.ops.tail import recognition_tail
    if inputs[0] == '-f':
        pytest.importorskip('pyarrow')
    args = ['test', '-m', SMOKE.KETOS_MODEL, *inputs]
    before = lstm_recurrence.launches, recognition_tail.launches
    card = _ketos_report(args)
    assert lstm_recurrence.launches > before[0] and recognition_tail.launches > before[1]
    assert card.startswith('=== report') and card == _ketos_report(['-d', 'cpu', *args])


@pytest.mark.cuda
def test_recognition_evaluation_on_the_card_equals_the_cpu(cuda_device):
    """RecognitionModel.test of the flagship recognizer on 70 lines of the
    fixture page at batch 32, card against CPU: launches counted (3 cluster
    LSTM launches and 1 tail launch a batch), the CPU's metrics."""
    from PIL import Image
    from kraken_tpu_torch.configs import RecognitionTrainingConfig, RecognitionTrainingDataConfig
    from kraken_tpu_torch.ops.tail import recognition_tail
    from kraken_tpu_torch.train import RecognitionDataModule, RecognitionModel
    im = Image.open(RESOURCES / '170025120000003,0074.jpg')
    out = {}
    for device in ('cpu', 'cuda'):
        dm = RecognitionDataModule(RecognitionTrainingDataConfig(
            test_data=[SMOKE.ketos_page(im, 70)], format_type='xml', batch_size=32))
        dm.setup('test')
        module = RecognitionModel(RecognitionTrainingConfig(device=device),
                                  net=SMOKE.flagship_model('cpu'))
        module.setup('test', dm)
        SMOKE.reset_counts(lstm_recurrence)
        recognition_tail.launches = 0
        out[device] = module.test(dm)
        torch.cuda.synchronize()
    assert lstm_recurrence.design_launches == {'cluster': 3 * 3, 'stream': 0}
    assert recognition_tail.launches == 3
    assert out['cuda']['chars'] == out['cpu']['chars']
    assert abs(out['cuda']['accuracy'] - out['cpu']['accuracy']) <= 2 / out['cpu']['chars']


@pytest.mark.cuda
def test_segmentation_validation_on_the_card_equals_the_cpu(cuda_device):
    """SegmentationModel.validate of the shipped model on the fixture page,
    card against CPU: 5 GroupNorm launches, 1 ridge launch, no head launch;
    the metrics within 1e-6, baseline P/R/F1 equal."""
    from kraken_tpu_torch.ops.groupnorm import group_norm
    from kraken_tpu_torch.ops.ridge import sato_ridge_threshold
    from kraken_tpu_torch.ops.seghead import seg_head
    from kraken_tpu_torch.configs import (SegmentationTrainingConfig,
                                          SegmentationTrainingDataConfig)
    from kraken_tpu_torch.lib.util import default_segmentation_model
    from kraken_tpu_torch.train import SegmentationDataModule, SegmentationModel
    out = {}
    for device in ('cpu', 'cuda'):
        module = SegmentationModel.load_from_weights(SegmentationTrainingConfig(device=device),
                                                     default_segmentation_model())
        cm = module.net.user_metadata['class_mapping']
        dm = SegmentationDataModule(SegmentationTrainingDataConfig(
            test_data=[SMOKE.ketos_page(RESOURCES / '170025120000003,0074.jpg')],
            line_class_mapping=cm['baselines'], region_class_mapping=cm['regions']))
        dm.setup('test')
        dm.val_set = dm.test_set
        module.setup('test', dm)
        SMOKE.reset_seg_counts()
        out[device] = module.validate(dm)
        torch.cuda.synchronize()
    assert (group_norm.launches, sato_ridge_threshold.launches, seg_head.launches) == (5, 1, 0)
    for k in out['cpu']:
        if '_bl_' in k:
            assert out['cuda'][k] == out['cpu'][k], k
        else:
            assert abs(out['cuda'][k] - out['cpu'][k]) <= SMOKE.KETOS_METRIC_ATOL, k
