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
