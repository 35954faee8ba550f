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
for spec in ('[1,48,0,1 S1(1x0)1,3 Lbxo8 O1c20]',
             '[1,48,0,1 Cr3,3,8,2,2 Mp2,2 S1(1x0)1,3 Cl1,1,16 Te2,16,32 O1c20]'):
    with torch.no_grad():
        y, lens = VGSLModel(spec, generator=torch.Generator().manual_seed(0))(
            torch.rand(2, 1, 48, 64), torch.tensor([64, 33], dtype=torch.int32))
    assert y.shape[:2] == (2, 20) and bool(torch.isfinite(y).all())
for fixture in ('ocropy_small.mlmodel', 'te_small.safetensors'):
    assert load_models(res + '/' + fixture)[0].codec is not None
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
from kraken_tpu_torch.tasks import ForcedAlignmentTaskModel
aligned = ForcedAlignmentTaskModel.load_model(res + '/overfit.mlmodel').predict(
    Image.open(res + '/000236.png'),
    Segmentation(type='baselines', imagename=res + '/000236.png', text_direction='horizontal-lr',
                 script_detection=False,
                 lines=[BaselineLine(id='a0', baseline=[[0, 10], [2543, 10]],
                                     boundary=[[0, 0], [2543, 0], [2543, 155], [0, 155]],
                                     text='\u0721 \u0718\u0721 \u0717')]),
    RecognitionInferenceConfig(device='cpu', num_line_workers=0))
assert aligned.lines[0].prediction and aligned.lines[0].cuts
ro_task = SegmentationTaskModel(load_models(res + '/blla_small.safetensors')
                                + load_models(res + '/ro_small.safetensors'))
ro_seg = ro_task.predict(page, SegmentationInferenceConfig(device='cpu'))
assert sorted(ro_seg.line_orders[-1]) == list(range(len(ro_seg.lines)))
assert native.available()
import os, tempfile
from kraken_tpu_torch.kraken import cli
from kraken_tpu_torch.pipeline import process_pages
out = os.path.join(tempfile.mkdtemp(), 'page.xml')
cli.main(['-d', 'cpu', '-a', '-i', res + '/170025120000003,0074.jpg', out, 'segment', '-bl',
          'ocr', '-m', res + '/overfit_bl.safetensors'], standalone_mode=False)
assert open(out, encoding='utf-8').read().count('<TextLine') > 40
seg_model = SegmentationTaskModel.load_model()
pages = list(process_pages([page, page], vmodel, lambda im: seg_model.predict(
    im, SegmentationInferenceConfig(device='cpu'))))
assert len(pages) == 2 and all(len(recs) == len(seg.lines) > 10 for _, seg, recs in pages)
import io
from kraken_tpu_torch.binarization import nlbin
from kraken_tpu_torch.lib.pdf import extract_page_images
from kraken_tpu_torch.ops.binarize import nlbin_device
from kraken_tpu_torch.pageseg import segment as legacy_segment
gray = Image.open(res + '/input.jpg').convert('L').crop((0, 0, 600, 400))
assert set(np.unique(np.asarray(nlbin(gray))).tolist()) == {0, 255}
assert nlbin_device(np.asarray(gray), device='cpu').dtype == torch.bool
bw = Image.open(res + '/bw.png')
assert len(legacy_segment(bw).lines) > 20
jpeg = io.BytesIO()
gray.save(jpeg, format='JPEG')
objs = [b'<< /Type /Catalog /Pages 2 0 R >>', b'<< /Type /Pages /Kids [3 0 R] /Count 1 >>',
        b'<< /Type /Page /Parent 2 0 R /Resources << /XObject << /Im0 4 0 R >> >> >>',
        b'<< /Type /XObject /Subtype /Image /Width 600 /Height 400 /ColorSpace /DeviceGray '
        b'/BitsPerComponent 8 /Filter /DCTDecode /Length %d >>\\nstream\\n' % len(jpeg.getvalue())
        + jpeg.getvalue() + b'\\nendstream']
pdf, offsets = bytearray(b'%PDF-1.4\\n'), []
for num, body in enumerate(objs, 1):
    offsets.append(len(pdf))
    pdf += b'%d 0 obj\\n' % num + body + b'\\nendobj\\n'
xref = len(pdf)
pdf += b'xref\\n0 5\\n0000000000 65535 f \\n' + b''.join(b'%010d 00000 n \\n' % o for o in offsets)
pdf += b'trailer\\n<< /Size 5 /Root 1 0 R >>\\nstartxref\\n%d\\n%%%%EOF\\n' % xref
doc = os.path.join(tempfile.mkdtemp(), 'doc.pdf')
open(doc, 'wb').write(bytes(pdf))
assert [im.size for im in extract_page_images(doc)] == [(600, 400)]
from kraken_tpu_torch.ketos import cli as ketos
merge = res + '/merge_tests/'
ketos.main(['-d', 'cpu', 'test', '-m', merge + 'merge_codec_nfd.mlmodel',
            merge + '0006.jpg', merge + '0021.jpg'], standalone_mode=False)
import json
from kraken_tpu_torch.configs import SegmentationTrainingConfig, SegmentationTrainingDataConfig
from kraken_tpu_torch.train import SegmentationDataModule, SegmentationModel
page_json = json.loads(open(res + '/torch_align_page.json', encoding='utf-8').read())
page_json['imagename'] = res + '/170025120000003,0074.jpg'
seg_module = SegmentationModel.load_from_weights(SegmentationTrainingConfig(device='cpu'),
                                                 res + '/blla_small.safetensors')
cm = seg_module.net.user_metadata['class_mapping']
dm = SegmentationDataModule(SegmentationTrainingDataConfig(
    test_data=[Segmentation(**page_json)], line_class_mapping=cm['baselines'],
    region_class_mapping=cm['regions']))
dm.setup('test')
dm.val_set = dm.test_set
seg_module.setup('test', dm)
assert seg_module.validate(dm)['val_bl_f1'] > 0.5
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'kraken_tpu'))
print('FORBIDDEN', bad)
"""


def test_port_runs_without_jax_or_kraken_tpu(resources):
    """A fresh interpreter runs the port's recognition forward and engine
    (an ocropy and a transformer network among them), its segmentation (the task model and the legacy ``blla.segment``), its
    forced alignment, its neural reading order, its CLI (``segment -bl
    ocr`` to ALTO), its page pipeline, the host and the device nlbin, the
    legacy box segmenter, the PDF extractor, ``ketos test`` on path input
    and a segmentation model's validation on the CPU and never imports JAX
    or kraken_tpu (the test process itself has JAX)."""
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
    contrib = {p.stem for p in files if p.parent.name == 'contrib'}
    assert {'extract_lines', 'repolygonize', 'segmentation_overlay', 'heatmap_overlay',
            'print_word_spreader', 'generate_bidi_tables', 'set_seg_options',
            'add_neural_ro', 'test_per_file'} <= contrib
    scanned = {str(p.relative_to(REPO / 'kraken_tpu_torch')) for p in files[:-1]}
    assert {'ketos/__init__.py', 'ketos/recognition.py', 'ketos/segmentation.py',
            'ketos/dataset.py', 'ketos/weights.py', 'ketos/ro.py', 'ketos/util.py',
            'train/recognition.py', 'train/segmentation.py', 'train/metrics.py',
            'dataset/recognition.py', 'dataset/segmentation.py', 'dataset/arrow.py',
            'dataset/loader.py', 'dataset/utils.py', 'dataset/augmentation.py',
            'models/writers.py', 'models/_coreml_writer.py'} <= scanned
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
