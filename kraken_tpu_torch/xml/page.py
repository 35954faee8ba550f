"""
PageXML parsing (reference: kraken/lib/xml/page.py), including
Transkribus-style `custom` attribute structure types and reading orders.

ISO 639 language code normalization is applied when the optional `iso639`
package is installed; raw codes are passed through otherwise.
"""
import logging
from collections import defaultdict

from kraken_tpu_torch.containers import BaselineLine, BBoxLine, Region
from kraken_tpu_torch.xml.common import (PAGE_REGIONS, base_direction,
                                         parse_page_coords, parse_page_custom,
                                         parse_reading_order_groups)

logger = logging.getLogger(__name__)

__all__ = ['parse_page']

try:
    from iso639 import Lang
    from iso639.exceptions import InvalidLanguageValue

    def _norm_lang(code: str) -> str:
        try:
            return Lang(code).pt3
        except InvalidLanguageValue:
            return code
except ImportError:
    from kraken_tpu_torch.xml.iso639 import to_part3 as _norm_lang


def _element_langs(el, default=None):
    """Languages from the custom string and primary/secondaryLanguage attrs."""
    langs = []
    if (custom := el.get('custom')) is not None:
        cs = parse_page_custom(custom)
        for entry in cs.get('language', []):
            if (val := entry.get('type')) is not None:
                langs.append(_norm_lang(val))
    for attr in ('primaryLanguage', 'secondaryLanguage'):
        if (val := el.get(attr)) is not None:
            langs.append(_norm_lang(val))
    return langs or default


def parse_page(doc, filename, linetype: str) -> dict:
    """
    Parses a PageXML document into the common intermediate result consumed
    by XMLPage.
    """
    base_path = filename.parent
    if (page := doc.find('.//{*}Page')) is None or page.get('imageFilename') is None:
        raise ValueError(f'PageXML file carries no usable image filename: {filename}')
    page_dir = base_direction(page.get('readingDirection'))
    page_lang = _element_langs(page)
    imagename = base_path.joinpath(page.get('imageFilename'))
    image_size = int(page.get('imageWidth')), int(page.get('imageHeight'))
    if not image_size[0] or not image_size[1]:
        logger.warning(f'Unusable page dimensions {image_size} in {filename}; '
                       'reading the size from the image file instead.')
        try:
            from kraken_tpu_torch.lib.util import open_image
            with open_image(imagename) as im:
                image_size = im.size
        except Exception as e:
            raise ValueError(f'Unusable page dimensions {image_size} in {filename}, '
                             f'and the image file could not be opened: {imagename}: {e}')

    tag_set: set = {'default'}
    region_data = defaultdict(list)
    lines: dict = {}
    line_implicit = []
    region_implicit = []
    missing_region_ids: set = set()
    tr_region_order = []
    tr_line_order_tmp = defaultdict(list)

    for region in page.iterfind('./{*}*'):
        if not any(region.tag.endswith(k) for k in PAGE_REGIONS):
            continue
        region_id = region.get('id')
        coords_el = region.find('./{*}Coords')
        try:
            boundary = parse_page_coords(coords_el.get('points'))
        except Exception:
            logger.info(f'Region {region_id} without coordinates')
            boundary = None
        has_coords = boundary is not None

        tags = {}
        rtype = region.get('type')
        region_lang = _element_langs(region, page_lang)
        if (custom := region.get('custom')) is not None:
            cs = parse_page_custom(custom)
            if not rtype and (structure := cs.get('structure')) and 'type' in structure[0]:
                rtype = structure[0]['type']
            if (reg_ro := cs.get('readingOrder')) is not None and (idx := reg_ro[0].get('index')) is not None:
                if has_coords:
                    tr_region_order.append((region_id, int(idx)))
                else:
                    logger.warning(f'Region {region_id} from the custom reading order has '
                                   'no coordinates; skipped.')
            tags.update(cs)
        if region_lang is None:
            region_lang = page_lang
        if not rtype:
            rtype = PAGE_REGIONS[region.tag.split('}')[-1]]
        tags['type'] = [{'type': rtype}]
        if has_coords:
            region_data[rtype].append(Region(id=region_id, boundary=boundary,
                                             tags=tags, language=region_lang))
            region_implicit.append(region_id)
        else:
            missing_region_ids.add(region_id)
        region_dir = base_direction(region.get('readingDirection'))

        for line in region.iterfind('./{*}TextLine'):
            line_id = line.get('id')
            baseline = None
            try:
                baseline = parse_page_coords(line.find('./{*}Baseline').get('points'))
            except Exception:
                logger.info(f'TextLine {line_id} without baseline')
                if linetype == 'baselines':
                    continue
            boundary_l = None
            try:
                boundary_l = parse_page_coords(line.find('./{*}Coords').get('points'))
            except Exception:
                logger.info(f'TextLine {line_id} without polygon')
                if linetype == 'bbox':
                    continue

            text = ''
            source = line.find('./{*}TextEquiv')
            if source is None:
                source = line
            for el in source.findall('.//{*}Unicode'):
                if el.text:
                    text += el.text

            line_tags = {}
            if (custom := line.get('custom')) is not None:
                cs = parse_page_custom(custom)
                if (structure := cs.get('structure')) is not None and structure[0].get('type'):
                    line_tags['type'] = [{'type': structure[0]['type']}]
                if (line_ro := cs.get('readingOrder')) is not None and (lidx := line_ro[0].get('index')) is not None:
                    parent_custom = line.getparent().get('custom')
                    reg_cus = parse_page_custom(parent_custom) if parent_custom else {}
                    if 'readingOrder' not in reg_cus or 'index' not in reg_cus['readingOrder'][0]:
                        logger.info('Custom-attribute reading order is incomplete; ignoring it.')
                    elif not has_coords:
                        logger.warning(f'Region {region_id} from the custom reading order has '
                                       'no coordinates; skipped.')
                    else:
                        tr_line_order_tmp[int(reg_cus['readingOrder'][0]['index'])].append(
                            (int(lidx), line_id))
                line_tags.update(cs)

            line_dir = base_direction(line.get('readingDirection')) or region_dir or page_dir
            line_langs = _element_langs(line, region_lang)
            line_split = None
            if (split := line_tags.get('split')) is not None and len(split) == 1:
                line_split = split[0]['type']
                line_tags.pop('split')

            common = dict(id=line_id,
                          text=text,
                          tags=line_tags,
                          language=line_langs,
                          split=line_split,
                          base_dir=line_dir,
                          regions=[region_id] if has_coords else [])
            if linetype == 'baselines':
                lines[line_id] = BaselineLine(baseline=baseline, boundary=boundary_l, **common)
            else:
                flat = [c for pt in boundary_l for c in pt]
                lines[line_id] = BBoxLine(bbox=(min(flat[::2]), min(flat[1::2]),
                                                max(flat[::2]), max(flat[1::2])),
                                          **common)
            line_implicit.append(line_id)

    transkribus_orders = {
        'region_transkribus': {
            'order': [rid for rid, _ in sorted(tr_region_order, key=lambda kv: kv[1])],
            'is_total': len({rid for rid, _ in tr_region_order}) == len(tr_region_order),
            'description': 'Region order taken from `custom` attributes',
            'level': 'region'}
    }
    if tr_line_order_tmp:
        order = []
        for _, entries in sorted(tr_line_order_tmp.items()):
            order.extend(lid for _, lid in sorted(entries))
        transkribus_orders['line_transkribus'] = {'order': order,
                                                  'is_total': True,
                                                  'description': 'Line order taken from `custom` attributes',
                                                  'level': 'line'}

    raw_orders = {}
    if (ro_el := doc.find('.//{*}ReadingOrder')) is not None:
        for group, raw, is_total in parse_reading_order_groups(ro_el, 'regionRef'):
            raw_orders[group.get('id')] = {'order': raw,
                                           'is_total': is_total,
                                           'description': group.get('caption') or ''}

    return {'imagename': imagename,
            'image_size': image_size,
            'regions': dict(region_data),
            'lines': lines,
            'line_implicit_order': line_implicit,
            'region_implicit_order': region_implicit,
            'tag_set': tag_set,
            'raw_orders': raw_orders,
            'transkribus_orders': transkribus_orders,
            'missing_region_ids': missing_region_ids}
