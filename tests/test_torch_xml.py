"""
The port's ALTO/PageXML reader (kraken_tpu_torch.xml) against the JAX
package's: every ALTO and PageXML file of the test resources, read as
baselines and as boxes, gives the same Segmentation as a dict through
``XMLPage(...).to_container()``, the same sorted lines and regions, and
the invalid files raise the same exception types.
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import dataclasses
from pathlib import Path

import pytest

from kraken_tpu import xml as jax_xml
from kraken_tpu_torch import xml as torch_xml
from kraken_tpu_torch.containers import Segmentation as TorchSegmentation

RESOURCES = Path(__file__).resolve().parent / 'resources'
VALID = sorted(str(p.relative_to(RESOURCES)) for d in ('alto', 'page')
               for p in (RESOURCES / d).glob('*.xml')) + \
    ['170025120000003,0074.xml', '170025120000003,0074-lite.xml']
INVALID = sorted(str(p.relative_to(RESOURCES)) for d in ('alto', 'page')
                 for p in (RESOURCES / d / 'invalid').glob('*.xml'))


def test_the_corpus_is_found():
    assert len(VALID) == 12 and len(INVALID) == 7


@pytest.mark.parametrize('linetype', ['baselines', 'bbox'])
@pytest.mark.parametrize('name', VALID)
def test_to_container_equals_jax(name, linetype):
    jdoc = jax_xml.XMLPage(RESOURCES / name, linetype=linetype)
    tdoc = torch_xml.XMLPage(RESOURCES / name, linetype=linetype)
    assert tdoc.filetype == jdoc.filetype
    assert tdoc.imagename == jdoc.imagename
    assert tdoc.image_size == jdoc.image_size
    tseg = tdoc.to_container()
    assert isinstance(tseg, TorchSegmentation)
    assert dataclasses.asdict(tseg) == dataclasses.asdict(jdoc.to_container())
    assert [line.id for line in tdoc.get_sorted_lines()] == \
        [line.id for line in jdoc.get_sorted_lines()]
    assert [reg.id for reg in tdoc.get_sorted_regions()] == \
        [reg.id for reg in jdoc.get_sorted_regions()]


@pytest.mark.parametrize('name', INVALID)
def test_invalid_files_raise_as_in_jax(name):
    with pytest.raises(Exception) as jerr:
        jax_xml.XMLPage(RESOURCES / name)
    with pytest.raises(Exception) as terr:
        torch_xml.XMLPage(RESOURCES / name)
    assert type(terr.value) is type(jerr.value)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize('wrong, name', [('page', 'alto/bsb00084914_00007.xml'),
                                         ('alto', 'page/cPAS-2000.xml')])
def test_cross_format_raises_as_in_jax(wrong, name):
    with pytest.raises(Exception) as jerr:
        jax_xml.XMLPage(RESOURCES / name, filetype=wrong)
    with pytest.raises(Exception) as terr:
        torch_xml.XMLPage(RESOURCES / name, filetype=wrong)
    assert type(terr.value) is type(jerr.value)
