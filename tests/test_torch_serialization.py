"""
The port's serializers (kraken_tpu_torch.serialization) against the JAX
package's: every native template (ALTO, PageXML, hOCR, abbyyXML and the
HTML layout view) over the box, baseline, baseline-without-regions,
no-boundary and region-only Segmentations of tests/test_serialization.py,
in a horizontal and a vertical writing mode, with and without sub-line
segmentation and with processing steps, plus a custom Jinja template and
the accuracy report. The port's containers are built from the same
reference pickles. The two outputs are equal after the normalisation of
tests/test_torch_cli.py (generated ``_<uuid4>`` ids by order of first
appearance, PageXML timestamps, the version string) and nothing else.
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import copy
import pickle
from collections import Counter
from pathlib import Path

import pytest

from kraken_tpu import containers as jax_containers
from kraken_tpu import serialization as jax_serialization
from kraken_tpu_torch import containers as torch_containers
from kraken_tpu_torch import serialization as torch_serialization

from test_torch_cli import normalise

RESOURCES = Path(__file__).resolve().parent / 'resources'
TEMPLATES = ['alto', 'pagexml', 'hocr', 'abbyyxml', 'layout']
SEGMENTATIONS = ['box', 'baselines', 'baselines_no_regions', 'no_boundary', 'region_only']


def _unpickler(module):
    class _Unpickler(pickle.Unpickler):
        """Maps the reference's container classes onto one package's."""

        def find_class(self, mod, name):
            if mod == 'kraken.containers':
                return getattr(module, name)
            if mod.startswith('kraken.'):
                raise pickle.UnpicklingError(f'Unexpected reference class {mod}.{name}')
            return super().find_class(mod, name)
    return _Unpickler


def segmentation(module, kind: str):
    """One of the Segmentations of tests/test_serialization.py, built from
    the containers of `module`."""
    if kind == 'no_boundary':
        return module.Segmentation(
            type='baselines', imagename='foo.png', text_direction='horizontal-lr',
            script_detection=False, regions={},
            lines=[module.BaselineLine(id='line_no_boundary', baseline=[(10, 50), (200, 50)],
                                       boundary=None, text='test text'),
                   module.BaselineLine(id='line_normal', baseline=[(10, 100), (200, 100)],
                                       boundary=[(10, 80), (200, 80), (200, 120), (10, 120)],
                                       text='normal text')])
    pkl = 'box_rec.pkl' if kind == 'box' else 'bl_rec.pkl'
    with open(RESOURCES / pkl, 'rb') as fp:
        seg = _unpickler(module)(fp).load()
    lines = copy.deepcopy(seg.lines)
    regions = seg.regions
    if kind == 'baselines_no_regions':
        for line in lines:
            line.regions = []
        regions = {}
    if kind == 'region_only':
        lines = []
    return module.Segmentation(type=seg.type, imagename='foo.png',
                               text_direction='horizontal-lr', lines=lines,
                               script_detection=True, regions=regions)


def both(kind: str, **kwargs) -> tuple[str, str]:
    """The JAX and the port's serialization of one Segmentation."""
    outs = []
    for module, ser in ((jax_containers, jax_serialization),
                        (torch_containers, torch_serialization)):
        seg = segmentation(module, kind)
        args = dict(kwargs)
        if 'processing_steps' in args:
            args['processing_steps'] = [module.ProcessingStep(**step)
                                        for step in args['processing_steps']]
        outs.append(ser.serialize(seg, image_size=(2544, 156), **args))
    return outs[0], outs[1]


def test_the_port_builds_its_own_containers():
    seg = segmentation(torch_containers, 'baselines')
    assert type(seg).__module__ == 'kraken_tpu_torch.containers'
    assert type(seg.lines[0]).__module__ == 'kraken_tpu_torch.containers'


@pytest.mark.parametrize('writing_mode', ['horizontal-tb', 'vertical-lr'])
@pytest.mark.parametrize('template', TEMPLATES)
@pytest.mark.parametrize('kind', SEGMENTATIONS)
def test_native_templates_equal_jax(kind, template, writing_mode):
    jax_out, torch_out = both(kind, template=template, writing_mode=writing_mode)
    assert normalise(torch_out) == normalise(jax_out)


@pytest.mark.parametrize('template', ['alto', 'pagexml', 'hocr', 'abbyyxml'])
def test_without_sub_line_segmentation_equal_jax(template):
    jax_out, torch_out = both('baselines', template=template, sub_line_segmentation=False)
    assert normalise(torch_out) == normalise(jax_out)


@pytest.mark.parametrize('template', ['alto', 'pagexml'])
def test_processing_steps_equal_jax(template):
    steps = [{'id': '_0', 'category': 'processing', 'description': 'text recognition',
              'settings': {'model': 'foo.safetensors', 'pad': 16}}]
    jax_out, torch_out = both('baselines', template=template, processing_steps=steps)
    assert template != 'alto' or 'text recognition' in torch_out
    assert normalise(torch_out) == normalise(jax_out)


def test_custom_jinja_template_equals_jax(tmp_path):
    template = tmp_path / 'lines.tmpl'
    template.write_text(
        '{{ page.name }} {{ page.size | join("x") }} {{ metadata.version }}\n'
        '{% for entity in page.entities %}'
        '{% if entity.type == "region" %}{% for line in entity.lines %}'
        '{{ line.id }}\t{{ line.text }}\t{{ line.confidences | length }}\n'
        '{% endfor %}{% else %}{{ entity.id }}\t{{ entity.text }}\n{% endif %}'
        '{% endfor %}')
    jax_out, torch_out = both('baselines', template=template, template_source='custom')
    assert len(torch_out.splitlines()) > 10
    assert normalise(torch_out) == normalise(jax_out)


def test_render_report_equals_jax():
    args = ('model.safetensors', 1000, 50, 0.95, 0.96, 0.9,
            Counter({('a', 'b'): 10, ('c', ''): 2}), Counter({'Latin': 1000, 'Greek': 20}),
            5, Counter({'Latin': 10}), Counter({'Latin': 35, 'Greek': 3}))
    assert torch_serialization.render_report(*args) == jax_serialization.render_report(*args)
