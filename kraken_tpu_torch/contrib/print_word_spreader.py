#!/usr/bin/env python
"""
Post-processes kraken hOCR output so word bounding boxes enclose their words
with a little margin: removes the space-only ocrx_word spans kraken emits and
spreads their area onto the neighbouring words, optionally repairs oversized
boxes and summarizes per-word confidences into data- attributes.

Reference parity: kraken/contrib/print_word_spreader.py (behavioral
reimplementation of the same hOCR normalization: shareSpaceSpans /
fixBigWordSpans / confidenceSummary options). The counterpart of the JAX
package's contrib script; runs no model and needs lxml:

    python -m kraken_tpu_torch.contrib.print_word_spreader --input-dir in --output-dir out -s
"""
import html
import re
from pathlib import Path
from statistics import mean

import click

_XHTML = 'http://www.w3.org/1999/xhtml'
_BBOX_RE = re.compile(r'bbox (\d+) (\d+) (\d+) (\d+)')
_CONF_RE = re.compile(r'x_conf(?:s)?((?: [\d.]+)+)')


def _get_bbox(el):
    m = _BBOX_RE.search(html.unescape(el.get('title') or ''))
    return [int(g) for g in m.groups()] if m else None


def _set_bbox(el, bbox):
    title = html.unescape(el.get('title') or '')
    rest = '; '.join(p.strip() for p in title.split(';') if not p.strip().startswith('bbox'))
    el.set('title', f'bbox {bbox[0]} {bbox[1]} {bbox[2]} {bbox[3]}' + (f'; {rest}' if rest else ''))


def _words(tree):
    return tree.iterfind(f'.//{{{_XHTML}}}span[@class="ocrx_word"]') \
        if tree.getroot().tag.startswith(f'{{{_XHTML}}}') \
        else tree.iterfind('.//span[@class="ocrx_word"]')


def _share_space_spans(tree, margin=2):
    """Deletes space-only word spans, widening the flanking words into the gap."""
    for span in list(_words(tree)):
        if (span.text or '').strip() != '' or span.text is None:
            continue
        bbox = _get_bbox(span)
        prev = span.getprevious()
        nxt = span.getnext()
        if bbox is not None:
            mid = (bbox[0] + bbox[2]) // 2
            if prev is not None and (pb := _get_bbox(prev)) is not None:
                pb[2] = max(pb[2], mid - margin)
                _set_bbox(prev, pb)
            if nxt is not None and (nb := _get_bbox(nxt)) is not None:
                nb[0] = min(nb[0], mid + margin)
                _set_bbox(nxt, nb)
        parent = span.getparent()
        if prev is not None:
            prev.tail = (prev.tail or '') + ' '
        elif parent.text is not None:
            parent.text += ' '
        parent.remove(span)


def _fix_big_word_spans(tree):
    """Replaces word boxes larger than 1/6 of the page with their predecessor's."""
    page = tree.find(f'.//{{{_XHTML}}}div[@class="ocr_page"]')
    if page is None:
        page = tree.find('.//div[@class="ocr_page"]')
    page_bbox = _get_bbox(page) if page is not None else None
    if page_bbox is None:
        return
    page_area = (page_bbox[2] - page_bbox[0]) * (page_bbox[3] - page_bbox[1])
    prev_bbox = None
    for span in _words(tree):
        bbox = _get_bbox(span)
        if bbox is None:
            continue
        if (bbox[2] - bbox[0]) * (bbox[3] - bbox[1]) > page_area / 6 and prev_bbox:
            _set_bbox(span, prev_bbox)
        else:
            prev_bbox = bbox


def _confidence_summary(tree):
    """Folds x_conf values into data-min/average-confidence attributes."""
    for span in _words(tree):
        title = html.unescape(span.get('title') or '')
        m = _CONF_RE.search(title)
        if m:
            confs = [float(c) for c in m.group(1).split()]
            span.set('data-min-confidence', f'{min(confs):.1f}')
            span.set('data-average-confidence', f'{mean(confs):.1f}')
        span.set('title', title.split(';')[0].strip())


@click.command()
@click.option('--input-dir', 'input_dir', required=True,
              type=click.Path(exists=True, file_okay=False))
@click.option('--output-dir', 'output_dir', required=True, type=click.Path(file_okay=False))
@click.option('-s', '--share-space-spans', is_flag=True,
              help='Remove space-only word spans, spreading their area to neighbours.')
@click.option('-f', '--fix-big-word-spans', is_flag=True,
              help='Replace word boxes larger than 1/6 of the page with the previous box.')
@click.option('-c', '--confidence-summary', is_flag=True,
              help='Summarize x_conf values into data- attributes and trim titles.')
def cli(input_dir, output_dir, share_space_spans, fix_big_word_spans, confidence_summary):
    from lxml import etree
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    parser = etree.HTMLParser(recover=True)
    for f in sorted(Path(input_dir).glob('*.html')) + sorted(Path(input_dir).glob('*.hocr')):
        try:
            tree = etree.parse(str(f))
        except etree.XMLSyntaxError:
            tree = etree.parse(str(f), parser)
        if share_space_spans:
            _share_space_spans(tree)
        if fix_big_word_spans:
            _fix_big_word_spans(tree)
        if confidence_summary:
            _confidence_summary(tree)
        tree.write(str(out / f.name), encoding='utf-8', method='xml')
        click.echo(f.name)


if __name__ == '__main__':
    cli()
