"""
The port (kraken_tpu_torch) stands alone: it imports neither JAX nor the
kraken_tpu package, and its entry points run on the card unless the caller
asks for the CPU (no silent fallback when there is no card).
"""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

# `kraken_tpu` as a module name but not as the prefix of `kraken_tpu_torch`
_JAX_PKG = r'kraken_tpu(?![\w])'
_IMPORT = re.compile(r'^\s*(?:from\s+(?P<from>[\w.]+)\s+import|import\s+(?P<imp>[\w., ]+))',
                     re.MULTILINE)

_CHILD = """
import sys, warnings
warnings.filterwarnings('ignore')
import numpy as np, torch
from PIL import Image
from kraken_tpu_torch.containers import BaselineLine, Segmentation
from kraken_tpu_torch.configs import RecognitionInferenceConfig
from kraken_tpu_torch.models import load_models
from kraken_tpu_torch.vgsl import VGSLModel
res = sys.argv[1]
model = VGSLModel('[1,48,0,1 Cr3,13,8 Mp2,2 Cr3,9,16 Mp2,2 S1(1x0)1,3 Lbx16 Lbx16 O1c20]',
                  generator=torch.Generator().manual_seed(0))
with torch.no_grad():
    y, lens = model(torch.rand(2, 1, 48, 64), torch.tensor([64, 33], dtype=torch.int32))
assert y.shape == (2, 20, 1, 16)
vmodel = load_models(res + '/overfit_bl_newpoly.safetensors')[0]
vmodel.prepare_for_inference(RecognitionInferenceConfig(device='cpu', num_line_workers=0))
seg = Segmentation(type='baselines', imagename=res + '/bw.png', text_direction='horizontal-lr',
                   script_detection=False,
                   lines=[BaselineLine(id='l0', baseline=[[0, 10], [2543, 10]],
                                       boundary=[[0, 0], [2543, 0], [2543, 155], [0, 155]])])
assert len(list(vmodel.predict(Image.open(res + '/000236.png'), seg))) == 1
from kraken_tpu_torch import blla, native
from kraken_tpu_torch.configs import SegmentationInferenceConfig
from kraken_tpu_torch.tasks import SegmentationTaskModel
page = Image.open(res + '/170025120000003,0074.jpg').resize((354, 512))
assert len(SegmentationTaskModel.load_model().predict(
    page, SegmentationInferenceConfig(device='cpu')).lines) > 10
assert blla.segment(page, device='cpu').type == 'baselines'
assert native.available()
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'kraken_tpu'))
print('FORBIDDEN', bad)
"""


def test_port_runs_without_jax_or_kraken_tpu(resources):
    """A fresh interpreter runs the port's recognition forward and engine
    and its segmentation (the task model and the legacy ``blla.segment``)
    on the CPU and never imports JAX or kraken_tpu (the test process itself
    has JAX)."""
    out = subprocess.run([sys.executable, '-c', _CHILD, str(resources)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert 'FORBIDDEN []' in out.stdout, out.stdout


def _forbidden_imports(source: str) -> list[str]:
    """Modules of JAX or of the kraken_tpu package that `source` imports."""
    found = []
    for m in _IMPORT.finditer(source):
        names = [m.group('from')] if m.group('from') else \
            [n.strip().split(' ')[0] for n in m.group('imp').split(',')]
        for name in names:
            root = name.split('.')[0]
            if root in ('jax', 'jaxlib', 'optax') or re.fullmatch(_JAX_PKG, root):
                found.append(name)
    return found


def test_source_scan_finds_no_jax_imports():
    files = sorted((REPO / 'kraken_tpu_torch').rglob('*.py')) + [REPO / 'chip_smoke.py']
    assert len(files) > 20
    found = {str(p.relative_to(REPO)): _forbidden_imports(p.read_text()) for p in files}
    assert {k: v for k, v in found.items() if v} == {}


@pytest.mark.parametrize('source, expected', [
    ('import kraken_tpu\n', ['kraken_tpu']),
    ('from kraken_tpu.vgsl import VGSLModel\n', ['kraken_tpu.vgsl']),
    ('import numpy, jax.numpy as jnp\n', ['jax.numpy']),
    ('    from jax import lax\n', ['jax']),
    ('import kraken_tpu_torch.vgsl\nfrom kraken_tpu_torch import nn\n', []),
])
def test_source_scan_tells_the_packages_apart(source, expected):
    """The scan flags JAX and kraken_tpu imports, not kraken_tpu_torch ones."""
    assert _forbidden_imports(source) == expected


def test_prepare_without_gpu_raises(monkeypatch, resources):
    from kraken_tpu_torch.configs import RecognitionInferenceConfig
    from kraken_tpu_torch.models import load_models
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    model = load_models(resources / 'overfit.mlmodel')[0]
    assert RecognitionInferenceConfig().device == 'cuda'
    with pytest.raises(RuntimeError, match='no CUDA device'):
        model.prepare_for_inference(RecognitionInferenceConfig())
    assert model.device.type == 'cpu'


def test_load_any_without_gpu_raises(monkeypatch, resources):
    from kraken_tpu_torch.lib.models import load_any
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        load_any(resources / 'overfit.mlmodel')
