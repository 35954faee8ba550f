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
from kraken_tpu_torch.ops.lstm import lstm_recurrence, lstm_recurrence_reference
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
    with torch.inference_mode():
        y, olens = model(x, lens)
    torch.cuda.synchronize()
    # one launch per LSTM layer, both directions of the BiLSTM in one
    assert lstm_recurrence.launches == before + 2
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
    records = list(model.predict(Image.open(RESOURCES / '000236.png'), seg))
    assert len(records) == 5
    assert lstm_recurrence.launches == before + 2 * 2  # two batches, two LSTM layers
    assert all(len(r.cuts) == len(r.prediction) for r in records)
