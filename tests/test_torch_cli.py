"""
The port's ``kraken`` CLI (kraken_tpu_torch.kraken, run with ``-d cpu``)
against the JAX package's on the CPU. Both are driven in this process
through click's runner and compared by the files they write (both log
through the logger ``kraken``):

- ``segment -bl ocr -m overfit_bl.safetensors`` on the fixture page: the
  native text, byte for byte; ``segment -bl`` alone: the same JSON;
- ``-f xml`` input to ALTO, PageXML, hOCR and abbyyXML: the same
  documents, schema-valid (ALTO 4.3, PAGE 2019, FineReader 10);
- ``ocr -s`` on a line image, the recognizer's options and ``show`` on a
  local model;
- the golden ``tests/resources/torch_cli_golden.json`` (the JAX CLI's
  native text of the fixture page and its normalised ALTO of the fixture
  XML, which the card holds the port's CLI to) equals a fresh JAX run;
- without a card a run that does not ask for ``--device cpu`` fails, and
  so do the parts that a later slice ports and the options left out.

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
import contextlib
import json
import re
import warnings
from pathlib import Path

import click
import pytest
import torch
from click.testing import CliRunner

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


def run(cli, args: list, out: Path) -> str:
    """Runs a CLI and returns the text of the file it wrote."""
    with jax_writing_mode(), warnings.catch_warnings():
        warnings.simplefilter('ignore')
        result = CliRunner().invoke(cli.cli, [str(a) for a in args])
    assert result.exit_code == 0, (result.output, result.exception)
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
    outputs = []
    for cli in (jax_kraken, torch_kraken):
        result = CliRunner().invoke(cli.cli, ['-d', 'cpu', 'show', str(RESOURCES / 'overfit.mlmodel')])
        assert result.exit_code == 0, result.output
        outputs.append(result.output)
    assert 'model type: recognition' in outputs[1] and 'alphabet:' in outputs[1]
    assert outputs[1] == outputs[0]


def test_show_refuses_a_repository_id():
    result = CliRunner().invoke(torch_kraken.cli, ['-d', 'cpu', 'show', '10.5281/zenodo.0'])
    assert result.exit_code == 2
    assert 'not a local model file' in result.output


def test_without_a_card_the_default_device_fails(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    result = CliRunner().invoke(torch_kraken.cli, ['-i', str(PAGE), str(tmp_path / 'x.txt'),
                                                   'segment', '-bl'])
    assert result.exit_code == 2
    assert '--device cpu' in result.output
    assert not (tmp_path / 'x.txt').exists()


@pytest.mark.parametrize('args, says', [
    (['binarize'], 'queue 1, item 8'),
    (['segment'], 'queue 1, item 8'),
    (['segment', '-x'], 'queue 1, item 8'),
    (['-f', 'pdf', 'segment', '-bl'], 'queue 1, item 8'),
    (['segment', '-bl', '--transfer', 'bytes'], 'No such option'),
    (['segment', '-bl', '--devices', '2'], 'No such option'),
    (['segment', '-bl', '--device-vectorize'], 'No such option'),
    (['ocr', '-m', 'x', '--transfer', 'bytes'], 'No such option'),
    (['ocr', '-m', 'x', '--devices', '2'], 'No such option'),
    (['list'], 'No such command'),
    (['get', 'x'], 'No such command'),
], ids=lambda v: ' '.join(v) if isinstance(v, list) else None)
def test_parts_not_ported_fail(args, says, tmp_path):
    result = CliRunner().invoke(torch_kraken.cli, ['-d', 'cpu', '-i', str(PAGE),
                                                   str(tmp_path / 'x.txt'), *args])
    assert result.exit_code == 2, result.output
    assert says in result.output
    assert not (tmp_path / 'x.txt').exists()


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
