"""
The port's ``kraken`` CLI (kraken_tpu_torch.kraken, run with ``-d cpu``)
against the JAX package's on the CPU. Both are driven in this process
through click's runner and compared by the files they write (both log
through the logger ``kraken``):

- ``segment -bl ocr -m overfit_bl.safetensors`` on the fixture page: the
  native text, byte for byte; ``segment -bl`` alone: the same JSON;
- ``-f xml`` input to ALTO, PageXML, hOCR and abbyyXML: the same
  documents, schema-valid (ALTO 4.3, PAGE 2019, FineReader 10);
- ``binarize`` on the host: the same PNG bytes; ``binarize --accel
  device``: the same pixels but where the flattened page lies within 1e-5
  of the threshold; the legacy box segmenter ``segment -x`` (the default,
  and with its options): the same JSON; ``segment -x ocr``: the same
  native text and ALTO; ``binarize segment -x ocr`` on a grey page; ``-f
  pdf`` over a scanned PDF: the same text a page; the
  ``recognition_boxes`` contrib script: the same picture;
- ``ocr -s`` on a line image, the recognizer's options and ``show`` on a
  local model (but for the alphabet's space, which the port names
  ``SPACE``: a fault of the JAX package, ROADMAP.md §3);
- ``show`` of a repository record, ``list`` and ``get`` without the
  optional ``htrmopo`` package: exit 1 with the same message
  (``tests/test_torch_repo.py`` holds them on a fake ``htrmopo``);
- the golden ``tests/resources/torch_cli_golden.json`` (the JAX CLI's
  native text of the fixture page and its normalised ALTO of the fixture
  XML, which the card holds the port's CLI to) equals a fresh JAX run;
- without a card a run that does not ask for ``--device cpu`` fails.

Outputs are normalised in three things only: each generated ``_<uuid4>``
id (renamed by its order of first appearance), the PageXML
``<Created>``/``<LastChange>`` timestamps and the version string. A
confidence printed in a document is a float of the recognition forward,
which the two packages compute in another order (the port's confidences
are within 1e-5 of JAX's, tests/test_torch_rpred.py): decimal numbers may
differ by 1e-5 plus one unit of their last printed digit; every other
character must be equal.

Two faults of the JAX CLI are repaired in the port. Its ALTO leaves out
the ID that ALTO 4.3 requires on the UnorderedGroup of several line orders
(the fixture XML has three), so the port's ALTO is compared with that ID
taken out (:func:`as_jax_alto`). It sets the serializers' writing mode in
``segment`` only, so its
``-f xml ... ocr`` to a serialized format stops on the missing key. The
port's ``ocr`` defaults it to its ``-d`` option; here the JAX CLI's
recognizer stage is wrapped to do the same (the JAX package is not
changed).

Write the golden anew with ``JAX_PLATFORMS=cpu python -m tests.test_torch_cli``.
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import contextlib
import json
import re
import sys
import warnings
from pathlib import Path

import click
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

import kraken_tpu
import kraken_tpu.kraken as jax_kraken
import kraken_tpu_torch
from kraken_tpu_torch import kraken as torch_kraken

RESOURCES = Path(__file__).resolve().parent / 'resources'
PAGE = RESOURCES / '170025120000003,0074.jpg'
XML = RESOURCES / '170025120000003,0074.xml'
LITE_XML = RESOURCES / '170025120000003,0074-lite.xml'
REC = RESOURCES / 'overfit_bl.safetensors'
GOLDEN = RESOURCES / 'torch_cli_golden.json'
FORMATS = {'alto': '-a', 'pagexml': '-x', 'hocr': '-h', 'abbyyxml': '-y'}
SCHEMAS = {'alto': 'alto-4-3.xsd', 'pagexml': 'pagecontent.xsd',
           'abbyyxml': 'FineReader10-schema-v1.xml'}

_UUID = re.compile(r'_[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}')
_TIMESTAMP = re.compile(r'<(Created|LastChange)>[^<]*</\1>')
_DECIMAL = re.compile(r'\d+\.\d+(?:[eE][-+]?\d+)?')


def normalise(text: str) -> str:
    """Renames each ``_<uuid4>`` id by its order of first appearance and
    blanks the PageXML timestamps and the version string."""
    ids: dict = {}
    text = _UUID.sub(lambda m: ids.setdefault(m.group(0), f'_id{len(ids)}'), text)
    text = _TIMESTAMP.sub(r'<\1>TIMESTAMP</\1>', text)
    for version in {kraken_tpu.__version__, kraken_tpu_torch.__version__}:
        text = text.replace(version, 'VERSION')
    return text


def assert_same_document(port: str, jax: str) -> None:
    """Equal after :func:`normalise`, but for decimal numbers (the
    confidences), each within 1e-5 plus one unit of its last digit."""
    port, jax = normalise(port), normalise(jax)
    assert _DECIMAL.split(port) == _DECIMAL.split(jax)
    pairs = list(zip(_DECIMAL.findall(port), _DECIMAL.findall(jax)))
    for a, b in pairs:
        digits = len(re.split(r'[eE]', a)[0].split('.')[1])
        assert abs(float(a) - float(b)) <= 1e-5 + 10.0 ** -digits, (a, b)


def as_jax_alto(doc: str) -> str:
    """The port's ALTO with the one change it makes to the JAX serializer's
    taken out: the ID that ALTO 4.3 requires on the UnorderedGroup of
    several line orders (the JAX documents with one are not schema-valid)."""
    group = '<UnorderedGroup ID="ro_orders">'
    return doc.replace(group, '<UnorderedGroup>')


@contextlib.contextmanager
def jax_writing_mode():
    """Has the JAX CLI's recognizer stage default the writing mode to its
    own text direction when no `segment` ran, as the port's `ocr` does."""
    original = jax_kraken.recognizer

    def recognizer(model, no_segmentation, config, linetype, input, output):
        click.get_current_context().meta.setdefault('text_direction', config.text_direction)
        return original(model, no_segmentation, config, linetype, input, output)
    jax_kraken.recognizer = recognizer
    try:
        yield
    finally:
        jax_kraken.recognizer = original


def invoke(cli, args: list) -> None:
    """Runs a CLI, which must succeed."""
    with jax_writing_mode(), warnings.catch_warnings():
        warnings.simplefilter('ignore')
        result = CliRunner().invoke(cli.cli, [str(a) for a in args])
    assert result.exit_code == 0, (result.output, result.exception)


def run(cli, args: list, out: Path) -> str:
    """Runs a CLI and returns the text of the file it wrote."""
    invoke(cli, args)
    return out.read_text(encoding='utf-8')


def jax_run(args: list, out: Path) -> str:
    return run(jax_kraken, ['-d', 'cpu', *args], out)


def torch_run(args: list, out: Path) -> str:
    return run(torch_kraken, ['-d', 'cpu', *args], out)


def page_args(out: Path, *stages) -> list:
    return ['-i', PAGE, out, *stages]


def xml_args(fmt: str, xml: Path, out: Path, *ocr_options) -> list:
    return [FORMATS[fmt], '-f', 'xml', '-i', xml, out, 'ocr', '-m', REC, *ocr_options]


def golden_runs(tmp: Path) -> dict:
    """The JAX CLI's outputs the golden holds: the native text of
    `segment -bl ocr` on the fixture page and the normalised ALTO of the
    fixture XML through `ocr`."""
    return {'text': jax_run(page_args(tmp / 'page.txt', 'segment', '-bl', 'ocr', '-m', REC),
                            tmp / 'page.txt'),
            'alto': normalise(jax_run(xml_args('alto', XML, tmp / 'alto.xml'),
                                      tmp / 'alto.xml'))}


@pytest.fixture(scope='module')
def jax_outputs(tmp_path_factory):
    """Every JAX CLI run of this file, once."""
    tmp = tmp_path_factory.mktemp('jax_cli')
    outs = golden_runs(tmp)
    outs['segment'] = jax_run(page_args(tmp / 'seg.json', 'segment', '-bl'), tmp / 'seg.json')
    for fmt in FORMATS:
        outs[fmt] = jax_run(xml_args(fmt, XML, tmp / f'{fmt}.xml'), tmp / f'{fmt}.xml')
    return outs


def test_segment_ocr_native_text_equals_jax(jax_outputs, tmp_path):
    out = tmp_path / 'page.txt'
    text = torch_run(page_args(out, 'segment', '-bl', 'ocr', '-m', REC), out)
    assert len(text.splitlines()) > 40
    assert text == jax_outputs['text']


def test_segment_json_equals_jax(jax_outputs, tmp_path):
    out = tmp_path / 'seg.json'
    seg = torch_run(page_args(out, 'segment', '-bl'), out)
    assert json.loads(seg)['type'] == 'baselines'
    assert normalise(seg) == normalise(jax_outputs['segment'])


@pytest.mark.parametrize('options', [['--transfer', 'bytes'], ['--device-vectorize'],
                                     ['--transfer', 'bytes', '--device-vectorize']],
                         ids=lambda v: ' '.join(v))
def test_segment_device_options_equal_jax(jax_outputs, options, tmp_path):
    """``segment --transfer bytes`` (the page up as bytes, the heatmap
    download picked by the link probe: 'uint8' on this machine in both) and
    ``--device-vectorize`` (the seam DPs in one batch) write the JAX CLI's
    JSON, which is the float command's."""
    out = tmp_path / 'seg.json'
    seg = torch_run(page_args(out, 'segment', '-bl', *options), out)
    want = jax_run(page_args(tmp_path / 'jax.json', 'segment', '-bl', *options),
                   tmp_path / 'jax.json')
    assert normalise(seg) == normalise(want) == normalise(jax_outputs['segment'])


@pytest.mark.parametrize('fmt', list(FORMATS))
def test_xml_input_serializations_equal_jax(fmt, jax_outputs, tmp_path):
    from lxml import etree
    out = tmp_path / f'{fmt}.xml'
    doc = torch_run(xml_args(fmt, XML, out), out)
    if fmt == 'alto':
        assert doc.count('<UnorderedGroup ID="ro_orders">') == 1
        assert_same_document(as_jax_alto(doc), jax_outputs[fmt])
    else:
        assert_same_document(doc, jax_outputs[fmt])
    if fmt in SCHEMAS:
        schema = etree.XMLSchema(etree.parse(str(RESOURCES / SCHEMAS[fmt])))
        schema.assertValid(etree.fromstring(doc.encode('utf-8')))


def test_golden_equals_a_fresh_jax_run(jax_outputs):
    golden = json.loads(GOLDEN.read_text(encoding='utf-8'))
    assert golden == {'text': jax_outputs['text'], 'alto': normalise(jax_outputs['alto'])}


@pytest.mark.parametrize('fmt, options', [
    ('alto', ['-B', '8', '-p', '8', '--no-reorder', '--no-legacy-polygons']),
    ('hocr', ['-t', '0.7', '--base-dir', 'R', '-d', 'vertical-lr', '--num-line-workers', '0']),
    ('pagexml', ['--decoder', 'beam', '--beam-size', '4']),
], ids=['batch-pad-reorder', 'temperature-basedir-direction', 'beam'])
def test_recognizer_options_equal_jax(fmt, options, tmp_path):
    jax_doc = jax_run(xml_args(fmt, LITE_XML, tmp_path / 'jax.xml', *options), tmp_path / 'jax.xml')
    doc = torch_run(xml_args(fmt, LITE_XML, tmp_path / 'port.xml', *options),
                    tmp_path / 'port.xml')
    assert_same_document(as_jax_alto(doc), jax_doc)


def test_ocr_no_segmentation_equals_jax(tmp_path):
    args = ['-i', RESOURCES / '000236.png', tmp_path / 'line.txt', 'ocr', '-s',
            '-m', RESOURCES / 'overfit.mlmodel', '--num-line-workers', '0']
    jax_text = jax_run(args, tmp_path / 'line.txt')
    text = torch_run(args, tmp_path / 'line.txt')
    assert text.strip()
    assert text == jax_text


def test_show_local_model_equals_jax():
    """The JAX CLI's output but for the alphabet's space, which the port
    names SPACE where the JAX package prints a blank (ROADMAP.md §3)."""
    from kraken_tpu.lib.util import make_printable
    from kraken_tpu.models import load_models
    model = RESOURCES / 'overfit.mlmodel'
    outputs = []
    for cli in (jax_kraken, torch_kraken):
        result = CliRunner().invoke(cli.cli, ['-d', 'cpu', 'show', str(model)])
        assert result.exit_code == 0, result.output
        outputs.append(result.output)
    assert 'model type: recognition' in outputs[1] and 'alphabet:' in outputs[1]
    chars = sorted(load_models(str(model))[0].codec.c2l)
    assert ' ' in chars
    jax_line = 'alphabet: ' + ' '.join(make_printable(c) for c in chars)
    line = 'alphabet: ' + ' '.join('SPACE' if c == ' ' else make_printable(c) for c in chars)
    assert jax_line + '\n' in outputs[0]
    assert outputs[1] == outputs[0].replace(jax_line + '\n', line + '\n')
    assert outputs[1] != outputs[0]


def test_show_refuses_a_repository_id(monkeypatch):
    """A remote ``show`` goes to the model repository; without the
    optional htrmopo package it exits 1 with the JAX CLI's message."""
    monkeypatch.setitem(sys.modules, 'htrmopo', None)
    results = [CliRunner().invoke(cli.cli, ['-d', 'cpu', 'show', '10.5281/zenodo.0'])
               for cli in (jax_kraken, torch_kraken)]
    assert results[1].exit_code == results[0].exit_code == 1
    assert 'requires the `htrmopo` package' in results[1].output
    assert results[1].output == results[0].output


def test_without_a_card_the_default_device_fails(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    result = CliRunner().invoke(torch_kraken.cli, ['-i', str(PAGE), str(tmp_path / 'x.txt'),
                                                   'segment', '-bl'])
    assert result.exit_code == 2
    assert '--device cpu' in result.output
    assert not (tmp_path / 'x.txt').exists()


@pytest.mark.parametrize('args, says', [
    (['list'], 'requires the `htrmopo` package'),
    (['get', 'x'], 'requires the `htrmopo` package'),
], ids=lambda v: ' '.join(v) if isinstance(v, list) else None)
def test_parts_not_ported_fail(args, says, tmp_path, monkeypatch):
    """``list`` and ``get``, ported since, fail without the optional
    htrmopo package as the JAX CLI's do: exit 1, its message, no output."""
    monkeypatch.setitem(sys.modules, 'htrmopo', None)
    results = []
    for tag, cli in (('jax', jax_kraken), ('port', torch_kraken)):
        out = tmp_path / f'{tag}.txt'
        results.append(CliRunner().invoke(cli.cli, ['-d', 'cpu', '-i', str(PAGE), str(out), *args]))
        assert not out.exists()
    assert results[1].exit_code == 1, results[1].output
    assert says in results[1].output
    assert results[1].output == results[0].output and results[0].exit_code == 1


def run_both(args: list, tmp: Path, name: str) -> tuple[Path, Path]:
    """Runs the JAX CLI and the port's with `args`, each writing `name`
    into a directory of its own (`args` name the output as OUT)."""
    outs = []
    for tag, cli in (('jax', jax_kraken), ('port', torch_kraken)):
        (tmp / tag).mkdir(exist_ok=True)
        out = tmp / tag / name
        invoke(cli, ['-d', 'cpu', *(out if a == 'OUT' else a for a in args)])
        outs.append(out)
    return outs[0], outs[1]


def test_binarize_host_png_equals_jax(tmp_path):
    jax_png, port_png = run_both(['-i', RESOURCES / 'input.jpg', 'OUT', 'binarize'], tmp_path,
                                 'bin.png')
    assert port_png.read_bytes() == jax_png.read_bytes()
    with Image.open(port_png) as im:
        assert len(im.convert('L').getcolors(2)) == 2


def test_binarize_device_equals_jax(tmp_path):
    """``--accel device``: the port's nlbin_device on the CPU against the
    JAX one; pixels may differ only where the flattened page lies within
    1e-5 of the threshold."""
    import numpy as np
    import torch as _torch
    from kraken_tpu_torch.ops.binarize import _nlbin_flat
    args = ['-i', RESOURCES / 'input.jpg', 'OUT', 'binarize', '--accel', 'device']
    jax_png, port_png = run_both(args, tmp_path, 'bin.png')
    with Image.open(jax_png) as a, Image.open(port_png) as b:
        assert (a.mode, a.size) == (b.mode, b.size) == ('1', (1456, 2184))
        differ = np.asarray(a) != np.asarray(b)
    gray = np.asarray(Image.open(RESOURCES / 'input.jpg').convert('L'), np.float32) / 255.0
    near = (_nlbin_flat(_torch.from_numpy(gray)[None])[0] - 0.5).abs().numpy() <= 1e-5
    assert not (differ & ~near).any()


@pytest.mark.parametrize('args', [['segment', '-x'], ['segment'],
                                  ['segment', '-x', '-b', '-m', '1', '-p', '5', '--scale', '10',
                                   '-l', '-d', 'horizontal-rl']],
                         ids=['x', 'default', 'options'])
def test_legacy_segment_json_equals_jax(args, tmp_path):
    jax_json, port_json = run_both(['-i', RESOURCES / 'bw.png', 'OUT', *args], tmp_path,
                                   'seg.json')
    seg = json.loads(port_json.read_text(encoding='utf-8'))
    assert seg['type'] == 'bbox' and len(seg['lines']) > 20
    assert normalise(port_json.read_text(encoding='utf-8')) == \
        normalise(jax_json.read_text(encoding='utf-8'))


@pytest.mark.parametrize('serializer', ['-n', '-a'], ids=['native', 'alto'])
def test_legacy_segment_ocr_equals_jax(serializer, tmp_path):
    from lxml import etree
    args = [serializer, '-i', RESOURCES / 'bw.png', 'OUT', 'segment', '-x', 'ocr', '-m',
            RESOURCES / 'overfit.mlmodel', '--num-line-workers', '0']
    jax_out, port_out = run_both(args, tmp_path, 'out.txt')
    doc = port_out.read_text(encoding='utf-8')
    if serializer == '-n':
        assert len(doc.splitlines()) == 30
        assert doc == jax_out.read_text(encoding='utf-8')
    else:
        assert_same_document(doc, jax_out.read_text(encoding='utf-8'))
        schema = etree.XMLSchema(etree.parse(str(RESOURCES / SCHEMAS['alto'])))
        schema.assertValid(etree.fromstring(doc.encode('utf-8')))


def test_binarize_segment_ocr_equals_jax(tmp_path):
    """The legacy path from a grey page: binarize, segment -x, ocr."""
    args = ['-i', RESOURCES / 'input.jpg', 'OUT', 'binarize', 'segment', '-x', 'ocr', '-m',
            RESOURCES / 'overfit.mlmodel', '--num-line-workers', '0']
    jax_out, port_out = run_both(args, tmp_path, 'out.txt')
    text = port_out.read_text(encoding='utf-8')
    assert len(text.splitlines()) > 20
    assert text == jax_out.read_text(encoding='utf-8')


def test_pdf_segment_ocr_equals_jax(tmp_path):
    """``-f pdf`` over a scanned two-page PDF (pages of bw.png): one text
    file a page, each the JAX CLI's."""
    import zlib
    import numpy as np
    import tests.test_pdf as pdf_tests
    with Image.open(RESOURCES / 'bw.png') as im:
        pages = [im.convert('L').crop((0, 0, 924, 800)), im.convert('L').crop((0, 800, 924, 1624))]
    objs = pdf_tests._doc_skeleton([3, 5])
    for num, page in ((3, pages[0]), (5, pages[1])):
        objs[num] = pdf_tests._page_obj(num, 2, img_ref=num + 1)
        objs[num + 1] = pdf_tests._image_obj(num + 1, zlib.compress(np.asarray(page).tobytes()),
                                             page.width, page.height, cs='/DeviceGray',
                                             filt='FlateDecode')
    texts = {}
    for tag, cli in (('jax', jax_kraken), ('port', torch_kraken)):
        (tmp_path / tag).mkdir()
        pdf = tmp_path / tag / 'doc.pdf'
        pdf.write_bytes(pdf_tests._assemble_classic(objs))
        invoke(cli, ['-d', 'cpu', '-f', 'pdf', '-o', '.txt', '-i', pdf, tmp_path / tag / 'x',
                     'segment', '-x', 'ocr', '-m', RESOURCES / 'overfit.mlmodel',
                     '--num-line-workers', '0'])
        texts[tag] = [(tmp_path / tag / f'doc_{i:06d}.txt').read_text(encoding='utf-8')
                      for i in range(2)]
    assert not (tmp_path / 'port' / 'doc_000002.txt').exists()
    assert all(len(t.splitlines()) > 5 for t in texts['port'])
    assert texts['port'] == texts['jax']


def test_recognition_boxes_equals_jax(tmp_path):
    """The contrib script of the legacy segmenter (tests/test_contrib.py:
    test_recognition_boxes), on the CPU: the JAX script's picture."""
    import shutil
    import numpy as np
    from kraken_tpu.contrib.recognition_boxes import cli as jax_cli
    from kraken_tpu_torch.contrib.recognition_boxes import cli as port_cli
    pictures = []
    for tag, cli, extra in (('jax', jax_cli, []), ('port', port_cli, ['-d', 'cpu'])):
        (tmp_path / tag).mkdir()
        shutil.copy(RESOURCES / 'bw.png', tmp_path / tag / 'bw.png')
        result = CliRunner().invoke(cli, ['-m', str(RESOURCES / 'overfit.mlmodel'), *extra,
                                          str(tmp_path / tag / 'bw.png')])
        assert result.exit_code == 0, result.output
        assert (tmp_path / tag / 'bw.png.boxes.png').exists(), result.output
        pictures.append(np.asarray(Image.open(tmp_path / tag / 'bw.png.boxes.png')))
    assert np.array_equal(pictures[1], pictures[0])


def test_recognition_boxes_needs_a_card_unless_asked(monkeypatch, tmp_path):
    from kraken_tpu_torch.contrib.recognition_boxes import cli
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    result = CliRunner().invoke(cli, ['-m', str(RESOURCES / 'overfit.mlmodel'),
                                      str(RESOURCES / 'bw.png')])
    assert result.exit_code == 2 and 'no CUDA device' in result.output


def test_an_unknown_device_is_a_usage_error(tmp_path):
    result = CliRunner().invoke(torch_kraken.cli, ['-d', 'tpu', 'show', str(REC)])
    assert result.exit_code == 2
    assert 'not a torch device' in result.output


if __name__ == '__main__':
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        GOLDEN.write_text(json.dumps(golden_runs(Path(tmp)), ensure_ascii=False) + '\n',
                          encoding='utf-8')
    print(f'wrote {GOLDEN}')
