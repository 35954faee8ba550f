"""
kraken_tpu_torch.serialization
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Serialization of segmentation/recognition results to ALTO 4.3, PageXML,
hOCR, and abbyyXML, plus accuracy report rendering.

The semantic layer (how records/regions/cuts are grouped into a page
structure) matches the reference serializer (kraken/serialization.py:80-269)
so documents round-trip through either engine; the rendering layer is
implemented as lxml document builders instead of Jinja templates (validated
against the same XSD schemas in the test suite). Custom user templates are
still supported through Jinja via ``template_source='custom'``.
"""
import datetime
import logging
import re
from typing import TYPE_CHECKING, Any, Iterable, Literal, Optional, Sequence

from kraken_tpu_torch import __version__
from kraken_tpu_torch.lib.util import make_printable

if TYPE_CHECKING:
    from collections import Counter
    from os import PathLike
    from kraken_tpu_torch.containers import ProcessingStep, Segmentation

logger = logging.getLogger(__name__)

__all__ = ['serialize', 'render_report', 'max_bbox']

_ALTO_NS = 'http://www.loc.gov/standards/alto/ns-v4#'
_PAGE_NS = 'http://schema.primaresearch.org/PAGE/gts/pagecontent/2019-07-15'
_XSI_NS = 'http://www.w3.org/2001/XMLSchema-instance'


def max_bbox(boxes: Iterable[Sequence[int]]) -> tuple[int, int, int, int]:
    """Smallest axis-aligned box covering all input point sequences."""
    flat = [coord for polygon in boxes for point in polygon for coord in point]
    return (min(flat[::2]), min(flat[1::2]), max(flat[::2]), max(flat[1::2]))


def _build_page_struct(results: 'Segmentation',
                       image_size,
                       writing_mode,
                       scripts,
                       sub_line_segmentation: bool) -> dict[str, Any]:
    """
    Groups records into the page/region/line/segment/char hierarchy shared by
    all output formats (semantics of reference serialization.py:118-250).
    """
    page: dict[str, Any] = {'entities': [],
                            'size': image_size,
                            'name': results.imagename,
                            'writing_mode': writing_mode,
                            'scripts': scripts,
                            'date': datetime.datetime.now(datetime.timezone.utc).isoformat(),
                            'seg_type': results.type}
    types = []
    for line in results.lines:
        if line.tags:
            for k, v in line.tags.items():
                types.extend((k, t['type']) for t in v if 'type' in t)
    for regs in results.regions.values():
        for reg in regs:
            if reg.tags:
                for k, v in reg.tags.items():
                    types.extend((k, t['type']) for t in v if 'type' in t)
    page['typology'] = sorted(set(types))
    page['line_orders'] = ([[results.lines[idx].id for idx in ro] for ro in results.line_orders]
                           if results.line_orders else [])

    reg_dict = {reg.id: reg for regs in results.regions.values() for reg in regs}
    regs_with_lines = set()
    prev_reg = None
    cur_ent = page['entities']
    seg_idx = 0
    char_idx = 0

    for record in results.lines:
        if not record.regions:
            cur_ent = page['entities']
        elif prev_reg != record.regions[0]:
            prev_reg = record.regions[0]
            reg = reg_dict[record.regions[0]]
            regs_with_lines.add(reg.id)
            region = {'id': reg.id,
                      'bbox': max_bbox([reg.boundary]) if reg.boundary else [],
                      'boundary': [list(x) for x in reg.boundary] if reg.boundary else [],
                      'tags': reg.tags,
                      'lines': [],
                      'language': reg.language,
                      'type': 'region'}
            page['entities'].append(region)
            cur_ent = region['lines']

        if record.type == 'baselines' and record.boundary:
            line_bbox = max_bbox([record.boundary])
            line_boundary = [list(x) for x in record.boundary]
        elif getattr(record, 'bbox', None):
            b = record.bbox
            line_bbox = b
            line_boundary = [[b[0], b[1]], [b[2], b[1]], [b[2], b[3]], [b[0], b[3]]]
        else:
            line_bbox = []
            line_boundary = []
        line = {'id': record.id,
                'bbox': line_bbox,
                'cuts': [list(x) for x in getattr(record, 'cuts', [])],
                'confidences': getattr(record, 'confidences', []),
                'recognition': [],
                'boundary': line_boundary,
                'language': record.language,
                'base_dir': record.base_dir,
                'type': 'line'}
        if record.tags is not None:
            line['tags'] = record.tags
        if record.type == 'baselines':
            line['baseline'] = [list(x) for x in record.baseline]

        if sub_line_segmentation:
            # whitespace-delimited segments with char-level entries
            offset = 0
            for segment in re.split(r'(\s+)', getattr(record, 'prediction', '')):
                if not segment:
                    continue
                seg_cuts = record.cuts[offset:offset + len(segment)]
                seg = {'bbox': max_bbox(seg_cuts) if seg_cuts else line_bbox,
                       'confidences': record.confidences[offset:offset + len(segment)],
                       'cuts': seg_cuts,
                       'text': segment,
                       'recognition': [{'bbox': max_bbox([cut]),
                                        'boundary': cut,
                                        'confidence': conf,
                                        'text': char,
                                        'index': cid}
                                       for conf, cut, char, cid in
                                       zip(record.confidences[offset:offset + len(segment)],
                                           seg_cuts, segment,
                                           range(char_idx, char_idx + len(segment)))],
                       'index': seg_idx}
                if record.type == 'baselines':
                    seg['boundary'] = record[offset:offset + len(segment)][1]
                line['recognition'].append(seg)
                char_idx += len(segment)
                seg_idx += 1
                offset += len(segment)
        else:
            line['text'] = getattr(record, 'prediction', '')
        cur_ent.append(line)

    for reg_id in regs_with_lines:
        reg_dict.pop(reg_id)
    for reg in reg_dict.values():
        page['entities'].append({'id': reg.id,
                                 'bbox': max_bbox([reg.boundary]) if reg.boundary else [],
                                 'boundary': [list(x) for x in reg.boundary] if reg.boundary else [],
                                 'tags': reg.tags,
                                 'lines': [],
                                 'type': 'region'})
    return page


# ------------------------------------------------------------------ helpers
def _points_str(pts) -> str:
    return ' '.join(f'{int(x)} {int(y)}' for x, y in pts)


def _points_str_comma(pts) -> str:
    return ' '.join(f'{int(x)},{int(y)}' for x, y in pts)


def _tagrefs(typology, tags) -> Optional[str]:
    """TYPE_n references of an element's tags within the sorted typology."""
    if not tags:
        return None
    refs = []
    for i, (ttype, label) in enumerate(typology, start=1):
        if ttype in tags and any(tv.get('type') == label for tv in tags[ttype]):
            refs.append(f'TYPE_{i}')
    return ' '.join(refs) if refs else None


def _custom_str(tags) -> Optional[str]:
    """Transkribus-style custom attribute from a tags dict."""
    if not tags:
        return None
    items = []
    for k, v in sorted(tags.items()):
        for tag in v:
            body = ''.join(f'{tk}:{tv};' for tk, tv in tag.items())
            items.append(f'{k} {{{body}}}')
    return ' '.join(items)


def _mean(vals) -> float:
    return sum(vals) / len(vals) if len(vals) else 0.0


# --------------------------------------------------------------------- ALTO
def _render_alto(page, metadata) -> str:
    from lxml import etree
    E = etree.Element
    nsmap = {None: _ALTO_NS, 'xsi': _XSI_NS}
    root = E(f'{{{_ALTO_NS}}}alto', nsmap=nsmap)
    root.set(f'{{{_XSI_NS}}}schemaLocation',
             'http://www.loc.gov/standards/alto/ns-v4# '
             'http://www.loc.gov/standards/alto/v4/alto-4-3.xsd')

    def sub(parent, tag, text=None, **attrs):
        el = etree.SubElement(parent, f'{{{_ALTO_NS}}}{tag}',
                              {k: str(v) for k, v in attrs.items() if v is not None})
        if text is not None:
            el.text = str(text)
        return el

    desc = sub(root, 'Description')
    sub(desc, 'MeasurementUnit', 'pixel')
    src = sub(desc, 'sourceImageInformation')
    sub(src, 'fileName', page['name'])
    cat_map = {'processing': 'contentGeneration', 'preprocessing': 'preOperation',
               'postprocessing': 'postOperation'}
    steps = metadata.get('processing_steps')
    if steps:
        for step in steps:
            proc = sub(desc, 'Processing', ID=f'OCR_{step.id}')
            sub(proc, 'processingCategory', cat_map.get(step.category, 'other'))
            sub(proc, 'processingStepDescription', step.description)
            sub(proc, 'processingStepSettings',
                '; '.join(f'{k}: {v}' for k, v in step.settings.items()))
            sw = sub(proc, 'processingSoftware')
            sub(sw, 'softwareName', 'kraken')
            sub(sw, 'softwareVersion', metadata['version'])
    else:
        proc = sub(desc, 'Processing', ID='OCR_0')
        sub(proc, 'processingCategory', 'other')
        sub(proc, 'processingStepDescription', 'unknown')
        sw = sub(proc, 'processingSoftware')
        sub(sw, 'softwareName', 'kraken')
        sub(sw, 'softwareVersion', metadata['version'])

    tags_el = sub(root, 'Tags')
    for i, (ttype, label) in enumerate(page['typology'], start=1):
        sub(tags_el, 'OtherTag', DESCRIPTION='', ID=f'TYPE_{i}', TYPE=ttype, LABEL=label)
    if len(tags_el) == 0:
        root.remove(tags_el)

    if page['line_orders']:
        ro_el = sub(root, 'ReadingOrder')
        # ALTO 4.3 requires an ID on the group (the JAX serializer leaves it
        # out, so its documents with several line orders are not valid)
        parent = ro_el if len(page['line_orders']) == 1 else \
            sub(ro_el, 'UnorderedGroup', ID='ro_orders')
        for g_idx, order in enumerate(page['line_orders']):
            group = sub(parent, 'OrderedGroup', ID=f'ro_{g_idx}')
            for o_idx, lid in enumerate(order, start=1):
                sub(group, 'ElementRef', ID=f'o_{g_idx}_{o_idx}', REF=lid)

    layout = sub(root, 'Layout')
    page_el = sub(layout, 'Page', WIDTH=page['size'][0], HEIGHT=page['size'][1],
                  PHYSICAL_IMG_NR=0, ID='page_0')
    space = sub(page_el, 'PrintSpace', HPOS=0, VPOS=0,
                WIDTH=page['size'][0], HEIGHT=page['size'][1])

    def render_line(parent, line):
        attrs = {'ID': line['id']}
        if line['bbox']:
            b = line['bbox']
            attrs.update(HPOS=b[0], VPOS=b[1], WIDTH=b[2] - b[0], HEIGHT=b[3] - b[1])
        if line.get('baseline'):
            attrs['BASELINE'] = _points_str(line['baseline'])
        refs = _tagrefs(page['typology'], line.get('tags'))
        if refs:
            attrs['TAGREFS'] = refs
        if line.get('base_dir'):
            attrs['BASEDIRECTION'] = 'rtl'
        tl = sub(parent, 'TextLine', **attrs)
        if line['boundary']:
            shape = sub(tl, 'Shape')
            sub(shape, 'Polygon', POINTS=_points_str(line['boundary']))
        if isinstance(line.get('text'), str):
            sub(tl, 'String', CONTENT=line['text'])
            return
        if not line['recognition']:
            sub(tl, 'String', CONTENT='')
            return
        for i, segment in enumerate(line['recognition']):
            bbox = segment['bbox']
            if segment['text'].isspace() and i > 0:
                sub(tl, 'SP', ID=f'segment_{segment["index"]}',
                    HPOS=bbox[0], VPOS=bbox[1],
                    WIDTH=bbox[2] - bbox[0], HEIGHT=bbox[3] - bbox[1])
            else:
                s = sub(tl, 'String', ID=f'segment_{segment["index"]}',
                        CONTENT=segment['text'], HPOS=bbox[0], VPOS=bbox[1],
                        WIDTH=bbox[2] - bbox[0], HEIGHT=bbox[3] - bbox[1],
                        WC=round(_mean(segment['confidences']), 4))
                if segment.get('boundary'):
                    shp = sub(s, 'Shape')
                    sub(shp, 'Polygon', POINTS=_points_str(segment['boundary']))
                for char in segment['recognition']:
                    cb = char['bbox']
                    g = sub(s, 'Glyph', ID=f'char_{char["index"]}',
                            CONTENT=char['text'], HPOS=cb[0], VPOS=cb[1],
                            WIDTH=cb[2] - cb[0], HEIGHT=cb[3] - cb[1],
                            GC=round(char['confidence'], 4))
                    if char.get('boundary'):
                        shp = sub(g, 'Shape')
                        sub(shp, 'Polygon', POINTS=_points_str(char['boundary']))

    block = None
    for i, entity in enumerate(page['entities']):
        if entity['type'] == 'region':
            attrs = {'ID': entity['id']}
            if entity['bbox']:
                b = entity['bbox']
                attrs.update(HPOS=b[0], VPOS=b[1], WIDTH=b[2] - b[0], HEIGHT=b[3] - b[1])
            refs = _tagrefs(page['typology'], entity.get('tags'))
            if refs:
                attrs['TAGREFS'] = refs
            block = sub(space, 'TextBlock', **attrs)
            if entity['bbox']:
                shp = sub(block, 'Shape')
                sub(shp, 'Polygon', POINTS=_points_str(entity['boundary']))
            for line in entity['lines']:
                render_line(block, line)
            block = None
        else:
            if block is None:
                block = sub(space, 'TextBlock', ID=f'textblock_{i + 1}')
            render_line(block, entity)
    return etree.tostring(root, xml_declaration=True, encoding='UTF-8',
                          pretty_print=True).decode('utf-8')


# ------------------------------------------------------------------ PageXML
def _render_pagexml(page, metadata) -> str:
    from lxml import etree
    nsmap = {None: _PAGE_NS, 'xsi': _XSI_NS}
    root = etree.Element(f'{{{_PAGE_NS}}}PcGts', nsmap=nsmap)
    root.set(f'{{{_XSI_NS}}}schemaLocation',
             f'{_PAGE_NS} {_PAGE_NS}/pagecontent.xsd')

    def sub(parent, tag, text=None, **attrs):
        el = etree.SubElement(parent, f'{{{_PAGE_NS}}}{tag}',
                              {k: str(v) for k, v in attrs.items() if v is not None})
        if text is not None:
            el.text = str(text)
        return el

    meta = sub(root, 'Metadata')
    sub(meta, 'Creator', f'kraken {metadata["version"]}')
    sub(meta, 'Created', page['date'])
    sub(meta, 'LastChange', page['date'])
    page_el = sub(root, 'Page', imageFilename=page['name'],
                  imageWidth=page['size'][0], imageHeight=page['size'][1])

    dir_map = {'R': 'right-to-left', 'L': 'left-to-right'}

    def render_line(parent, line):
        if not line['boundary']:
            return
        attrs = {'id': line['id']}
        custom = _custom_str(line.get('tags'))
        if custom:
            attrs['custom'] = custom
        if line.get('base_dir'):
            attrs['readingDirection'] = dir_map[line['base_dir']]
        tl = sub(parent, 'TextLine', **attrs)
        sub(tl, 'Coords', points=_points_str_comma(line['boundary']))
        if line.get('baseline'):
            sub(tl, 'Baseline', points=_points_str_comma(line['baseline']))
        if isinstance(line.get('text'), str):
            te = sub(tl, 'TextEquiv')
            sub(te, 'Unicode', line['text'])
            return
        for segment in line['recognition']:
            w = sub(tl, 'Word', id=f'segment_{segment["index"]}')
            if segment.get('boundary'):
                sub(w, 'Coords', points=_points_str_comma(segment['boundary']))
            else:
                b = segment['bbox']
                sub(w, 'Coords', points=f'{b[0]},{b[1]} {b[0]},{b[3]} {b[2]},{b[3]} {b[2]},{b[1]}')
            for char in segment['recognition']:
                g = sub(w, 'Glyph', id=f'char_{char["index"]}')
                sub(g, 'Coords', points=_points_str_comma(char['boundary']))
                te = sub(g, 'TextEquiv', conf=round(char['confidence'], 4))
                sub(te, 'Unicode', char['text'])
            te = sub(w, 'TextEquiv', conf=round(_mean(segment['confidences']), 4))
            sub(te, 'Unicode', segment['text'])
        if len(line['confidences']):
            te = sub(tl, 'TextEquiv', conf=round(_mean(line['confidences']), 4))
            sub(te, 'Unicode', ''.join(s['text'] for s in line['recognition']))

    region = None
    for i, entity in enumerate(page['entities']):
        if entity['type'] == 'region':
            attrs = {'id': entity['id']}
            custom = _custom_str(entity.get('tags'))
            if custom:
                attrs['custom'] = custom
            region = sub(page_el, 'TextRegion', **attrs)
            if entity['boundary']:
                sub(region, 'Coords', points=_points_str_comma(entity['boundary']))
            else:
                sub(region, 'Coords', points='0,0 0,0 0,0')
            for line in entity['lines']:
                render_line(region, line)
            region = None
        else:
            if region is None:
                region = sub(page_el, 'TextRegion', id=f'textblock_{i + 1}')
                w, h = page['size']
                sub(region, 'Coords', points=f'0,0 0,{h} {w},{h} {w},0')
            render_line(region, entity)
    return etree.tostring(root, xml_declaration=True, encoding='UTF-8',
                          pretty_print=True).decode('utf-8')


# --------------------------------------------------------------------- hOCR
def _render_hocr(page, metadata) -> str:
    from xml.sax.saxutils import escape, quoteattr

    out = ['<!DOCTYPE html>', '<html>', '<head>',
           '<meta http-equiv="Content-Type" content="text/html; charset=utf-8"/>',
           '<meta name="ocr-system" content="kraken"/>',
           '<meta name="ocr-capabilities" content="ocr_page ocrx_block ocr_line ocrx_word ocrp_poly"/>']
    if page['scripts']:
        out.append(f'<meta name="ocr-scripts" content="{" ".join(page["scripts"])}"/>')
    out += ['</head>', '<body>']
    out.append(f'<div class="ocr_page" title="bbox 0 0 {page["size"][0]} {page["size"][1]}; '
               f'image {escape(str(page["name"]))}" style="writing-mode: {page["writing_mode"]};">')

    def render_line(line):
        if not line['bbox']:
            return
        title = 'bbox ' + ' '.join(str(int(v)) for v in line['bbox'])
        if line['cuts']:
            cut_str = ' '.join(' '.join(str(int(c)) for pt in cut for c in pt) for cut in line['cuts'])
            title += f'; x_bboxes {cut_str}'
        if line['boundary']:
            title += '; poly ' + ' '.join(str(int(c)) for pt in line['boundary'] for c in pt)
        out.append(f'<span class="ocr_line" id="{line["id"]}" title={quoteattr(title)}>')
        for segment in line['recognition']:
            t = 'bbox ' + ' '.join(str(int(v)) for v in segment['bbox'])
            t += '; x_confs ' + ' '.join(str(c) for c in segment['confidences'])
            if segment.get('boundary'):
                t += '; poly ' + ' '.join(str(int(c)) for pt in segment['boundary'] for c in pt)
            out.append(f'<span class="ocrx_word" id="segment_{segment["index"]}" '
                       f'title={quoteattr(t)}>{escape(segment["text"])}</span>')
        out.append('</span>')
        out.append('<br/>')

    for entity in page['entities']:
        if entity['type'] == 'region':
            if entity['bbox']:
                rtype = ''
                if entity.get('tags') and entity['tags'].get('type'):
                    rtype = entity['tags']['type'][0].get('type', '')
                bbox_str = ' '.join(str(int(v)) for v in entity['bbox'])
                title = f'bbox {bbox_str}'
                if entity['boundary']:
                    title += '; poly ' + ' '.join(str(int(c)) for pt in entity['boundary'] for c in pt)
                out.append(f'<div class="ocrx_block" id="{entity["id"]}" '
                           f'data-region-type="{rtype}" title={quoteattr(title)}>')
                for line in entity['lines']:
                    render_line(line)
                out.append('</div>')
            else:
                for line in entity['lines']:
                    render_line(line)
        else:
            render_line(entity)
    out += ['</div>', '</body>', '</html>']
    return '\n'.join(out)


# ----------------------------------------------------------------- abbyyXML
def _render_abbyyxml(page, metadata) -> str:
    from lxml import etree
    ns = 'http://www.abbyy.com/FineReader_xml/FineReader10-schema-v1.xml'
    root = etree.Element(f'{{{ns}}}document', nsmap={None: ns},
                         version='1.0', producer=f'kraken {metadata["version"]}')
    page_el = etree.SubElement(root, f'{{{ns}}}page',
                               width=str(page['size'][0]), height=str(page['size'][1]),
                               resolution='0', originalCoords='1')

    def render_line(par, line):
        if not line['bbox']:
            return
        b = line['bbox']
        ln = etree.SubElement(par, f'{{{ns}}}line',
                              baseline=str(int((b[1] + b[3]) / 2)),
                              l=str(b[0]), r=str(b[2]), t=str(b[1]), b=str(b[3]))
        fmt = etree.SubElement(ln, f'{{{ns}}}formatting', lang='')
        first = True
        for segment in line['recognition']:
            for char in segment['recognition']:
                cb = char['bbox']
                cp = etree.SubElement(fmt, f'{{{ns}}}charParams',
                                      l=str(cb[0]), r=str(cb[2]), t=str(cb[1]), b=str(cb[3]),
                                      wordStart='1' if first else '0',
                                      charConfidence=str(int(char['confidence'] * 100)))
                cp.text = char['text']
                first = False

    for entity in page['entities']:
        block = etree.SubElement(page_el, f'{{{ns}}}block', blockType='Text')
        text = etree.SubElement(block, f'{{{ns}}}text')
        par = etree.SubElement(text, f'{{{ns}}}par')
        if entity['type'] == 'region':
            for line in entity['lines']:
                render_line(par, line)
        else:
            render_line(par, entity)
    return etree.tostring(root, xml_declaration=True, encoding='UTF-8',
                          pretty_print=True).decode('utf-8')


# ------------------------------------------------------------- layout HTML
_LAYOUT_CSS = """
body { margin: 0; font-family: sans-serif; display: flex; height: 100vh; }
#facsimile { position: relative; flex: 1; overflow: auto; background: #222; }
#facsimile img { display: block; width: 100%; }
#facsimile a.line-box { position: absolute; border: 1px solid rgba(220,40,40,.8);
  background: rgba(220,40,40,.08); }
#facsimile a.line-box:hover, #facsimile a.line-box.active {
  background: rgba(220,40,40,.35); }
#transcription { flex: 1; overflow: auto; padding: 1em; }
#transcription li { padding: .2em .4em; border-left: 3px solid transparent; }
#transcription li:focus, #transcription li.active {
  border-left-color: #dc2828; background: #f6f6f6; outline: none; }
#toolbar { position: fixed; bottom: 1em; right: 1em; }
""".strip()

_LAYOUT_JS = """
function hl(id, on) {
  document.querySelectorAll('[data-line="' + id + '"]').forEach(function (el) {
    el.classList.toggle('active', on);
  });
}
document.querySelectorAll('[data-line]').forEach(function (el) {
  el.addEventListener('mouseenter', function () { hl(el.dataset.line, true); });
  el.addEventListener('mouseleave', function () { hl(el.dataset.line, false); });
});
document.getElementById('download').addEventListener('click', function () {
  var text = Array.from(document.querySelectorAll('#transcription li'))
    .map(function (li) { return li.textContent.trim(); }).join('\\n');
  var a = document.createElement('a');
  a.href = URL.createObjectURL(new Blob([text], {type: 'text/plain'}));
  a.download = 'transcription.txt';
  a.click();
});
""".strip()


def _render_layout(page, metadata) -> str:
    """
    Self-contained HTML proofing view (inventory counterpart of the
    reference's templates/layout.html): the page facsimile with
    percent-positioned line overlays next to a per-line contenteditable
    transcription column, with hover cross-highlighting and plain-text
    download. Own markup/CSS/JS, not the reference template.
    """
    from xml.sax.saxutils import escape, quoteattr
    w, h = page['size']
    rtl = str(page.get('writing_mode', '')).endswith('rl')
    html_attrs = ' dir="rtl"' if rtl else ''
    lines = []
    for entity in page['entities']:
        if entity['type'] == 'region':
            lines.extend(entity['lines'])
        else:
            lines.append(entity)

    def line_text(line):
        if line.get('text'):
            return line['text']
        return ''.join(seg['text'] for seg in line['recognition'])

    out = ['<!DOCTYPE html>',
           f'<html{html_attrs}>', '<head>',
           '<meta charset="utf-8"/>',
           f'<meta name="ocr-system" content="kraken_tpu {metadata["version"]}"/>',
           f'<title>{escape(str(page["name"] or "kraken_tpu layout"))}</title>',
           f'<style>{_LAYOUT_CSS}</style>', '</head>', '<body>',
           '<div id="facsimile">',
           f'<img src={quoteattr(str(page["name"] or ""))} alt="page facsimile"/>']
    for line in lines:
        if not line['bbox'] or not w or not h:
            continue
        x0, y0, x1, y1 = line['bbox']
        style = (f'left: {100 * x0 / w:.2f}%; top: {100 * y0 / h:.2f}%; '
                 f'width: {100 * (x1 - x0) / w:.2f}%; height: {100 * (y1 - y0) / h:.2f}%;')
        out.append(f'<a class="line-box" data-line={quoteattr(str(line["id"]))} '
                   f'style={quoteattr(style)} '
                   f'title={quoteattr(line_text(line))}></a>')
    out += ['</div>', '<div id="transcription">', '<ol>']
    for line in lines:
        bbox = ' '.join(str(int(v)) for v in line['bbox']) if line['bbox'] else ''
        out.append(f'<li data-line={quoteattr(str(line["id"]))} data-bbox="{bbox}" '
                   f'contenteditable="true" spellcheck="true">'
                   f'{escape(line_text(line))}</li>')
    out += ['</ol>', '</div>',
            '<div id="toolbar"><button id="download">Download text</button></div>',
            f'<script>{_LAYOUT_JS}</script>',
            '</body>', '</html>']
    return '\n'.join(out)


_NATIVE_RENDERERS = {'alto': _render_alto,
                     'page': _render_pagexml,
                     'pagexml': _render_pagexml,
                     'hocr': _render_hocr,
                     'abbyyxml': _render_abbyyxml,
                     'layout': _render_layout}


def serialize(results: 'Segmentation',
              image_size: tuple[int, int] = (0, 0),
              writing_mode: Literal['horizontal-tb', 'vertical-lr', 'vertical-rl'] = 'horizontal-tb',
              scripts: Optional[Iterable[str]] = None,
              template: 'PathLike' = 'alto',
              template_source: Literal['native', 'custom'] = 'native',
              processing_steps: Optional[list['ProcessingStep']] = None,
              sub_line_segmentation: bool = True) -> str:
    """
    Serializes a Segmentation (with or without recognition records) into an
    output document.

    Args:
        results: Segmentation container.
        image_size: (width, height) of the source image.
        writing_mode: principal line layout for formats that record it.
        scripts: scripts contained in the OCR records.
        template: 'alto', 'page'/'pagexml', 'hocr', 'abbyyxml', 'layout'
                  (self-contained HTML proofing view), or a path to
                  a custom Jinja template when template_source='custom'.
        template_source: 'native' builders or 'custom' Jinja template.
        processing_steps: provenance records embedded in the output.
        sub_line_segmentation: emit word/char level segmentation.

    Returns:
        The rendered document as a string.
    """
    logger.info(f'Serialize {len(results.lines)} records from {results.imagename} '
                f'with template {template}.')
    page = _build_page_struct(results, image_size, writing_mode, scripts,
                              sub_line_segmentation)
    metadata = {'processing_steps': processing_steps, 'version': __version__}
    if template_source == 'native':
        if template not in _NATIVE_RENDERERS:
            raise ValueError(f'Unknown serialization template {template!r}')
        return _NATIVE_RENDERERS[template](page, metadata)
    # custom Jinja template
    from jinja2 import Environment, FunctionLoader

    def _load(name):
        with open(template, 'r') as fp:
            return fp.read(), name, lambda: True
    env = Environment(loader=FunctionLoader(_load), trim_blocks=True,
                      lstrip_blocks=True, autoescape=True)
    env.tests['whitespace'] = str.isspace
    env.filters['rescale'] = lambda val, low, high: [(high - low) * x + low for x in val]
    return env.get_template(str(template)).render(page=page, metadata=metadata)


def render_report(model: str,
                  chars: int,
                  errors: int,
                  char_accuracy: float,
                  char_CI_accuracy: float,
                  word_accuracy: float,
                  char_confusions: 'Counter',
                  scripts: 'Counter',
                  insertions: int,
                  deletions: 'Counter',
                  substitutions: 'Counter') -> str:
    """
    Renders a test/accuracy report with per-script error attribution and the
    most frequent character confusions.
    """
    lines = [f'=== report {model} ===', '',
             f'{chars}\tCharacters',
             f'{errors}\tErrors',
             f'{char_accuracy * 100:0.2f}%\tCharacter Accuracy',
             f'{char_CI_accuracy * 100:0.2f}%\tCharacter Accuracy (Case-insensitive)',
             f'{word_accuracy * 100:0.2f}%\tWord Accuracy', '',
             f'{insertions}\tInsertions',
             f'{sum(deletions.values())}\tDeletions',
             f'{sum(substitutions.values())}\tSubstitutions', '',
             'Count\tMissed\t%Right']
    script_rows = sorted(({'script': k,
                           'count': v,
                           'errors': deletions[k] + substitutions[k],
                           'accuracy': 100 * (v - (deletions[k] + substitutions[k])) / v}
                          for k, v in scripts.items()),
                         key=lambda x: x['accuracy'], reverse=True)
    for row in script_rows:
        lines.append(f'{row["count"]}\t{row["errors"]}\t{row["accuracy"]:0.2f}%\t{row["script"]}')
    lines += ['', 'Errors\tCorrect-Generated']
    confusion_rows = sorted(({'correct': make_printable(k[0]),
                              'generated': make_printable(k[1]),
                              'errors': v}
                             for k, v in char_confusions.items() if k[0] != k[1]),
                            key=lambda x: x['errors'], reverse=True)
    for row in confusion_rows:
        lines.append(f'{row["errors"]}\t{{ {row["correct"]} }} - {{ {row["generated"]} }}')
    return '\n'.join(lines) + '\n'
