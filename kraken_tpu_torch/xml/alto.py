"""
ALTO XML parsing (reference: kraken/lib/xml/alto.py).
"""
import logging
from collections import defaultdict

from kraken_tpu_torch.containers import BaselineLine, BBoxLine, Region
from kraken_tpu_torch.xml.common import (ALTO_REGIONS, base_direction,
                                         parse_alto_pointstype,
                                         parse_reading_order_groups)

logger = logging.getLogger(__name__)

__all__ = ['parse_alto']


def _resolve_tagrefs(tag_map: dict, tagrefs, tag_set: set, **defaults) -> dict:
    """
    Resolves a space-separated TAGREFS attribute against the document's tag
    declarations into a {type: [{'type': label}, ...]} dict, recording seen
    labels in `tag_set`. Tags without a TYPE default to 'type'.
    """
    tags: dict = {}
    for tagref in (tagrefs or '').split():
        _, tag_type, tag_label = tag_map.get(tagref, (None, None, None))
        if not tag_label:
            continue
        tag_type = tag_type or 'type'
        entry = [{'type': tag_label}]
        tag_set.add(tag_label)
        existing = tags.get(tag_type)
        if isinstance(existing, list):
            existing.extend(entry)
        elif existing is not None:
            tags[tag_type] = [existing] + entry
        else:
            tags[tag_type] = entry
    for k, v in defaults.items():
        tags.setdefault(k, v)
    return tags


def _element_langs(el, tag_map, tag_set, default=None):
    """Languages of an element from TAGREFS language tags + LANG attribute."""
    langs = []
    tags = _resolve_tagrefs(tag_map, el.get('TAGREFS'), tag_set)
    if (tag_langs := tags.get('language')) is not None:
        if isinstance(tag_langs, list):
            langs.extend(tl['type'] for tl in tag_langs)
        else:
            langs.append(tag_langs['type'])
    if (attr_lang := el.get('LANG')) is not None:
        langs.append(attr_lang)
    return langs or default


def parse_alto(doc, filename, linetype: str) -> dict:
    """
    Parses an ALTO document into the common intermediate result consumed by
    XMLPage: regions/lines with tags, implicit orders, raw explicit orders,
    and the String→line map used for order flattening.
    """
    base_dir_path = filename.parent

    if (mu := doc.find('.//{*}MeasurementUnit')) is not None and mu.text.strip() != 'pixel':
        raise ValueError(f'ALTO MeasurementUnit in {filename} is '
                         f'"{mu.text.strip()}" not "pixel".')
    if (image := doc.find('.//{*}fileName')) is None or not image.text:
        raise ValueError(f'ALTO file carries no usable image filename: {filename}')
    imagename = base_dir_path.joinpath(image.text)
    if (page := doc.find('.//{*}Page')) is None:
        raise ValueError(f'ALTO document lacks a Page element: {filename}')
    try:
        image_size = int(page.get('WIDTH')), int(page.get('HEIGHT'))
    except (ValueError, TypeError) as e:
        raise ValueError(f'Unusable page dimensions in {filename}: {e}')
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

    page_lang = page.get('LANG')

    # tag declarations
    tag_map = {}
    if (tag_block := doc.find('.//{*}Tags')) is not None:
        for kind in ('StructureTag', 'LayoutTag', 'OtherTag'):
            for tag in tag_block.findall(f'./{{*}}{kind}'):
                tag_map[tag.get('ID')] = (kind[:-3].lower(), tag.get('TYPE'), tag.get('LABEL'))

    tag_set: set = {'default'}
    lines: dict = {}
    region_data = defaultdict(list)
    line_implicit = []
    region_implicit = []
    missing_region_ids: set = set()
    string_to_line: dict = {}

    region_elements = [el for el in doc.iterfind('./{*}Layout/{*}Page/{*}PrintSpace/{*}*')
                       if any(el.tag.endswith(bt) for bt in ALTO_REGIONS)]

    for region in region_elements:
        region_id = region.get('ID')
        region_dir = base_direction(region.get('BASEDIRECTION'))

        boundary = None
        if (coords := region.find('./{*}Shape/{*}Polygon')) is not None:
            boundary = parse_alto_pointstype(coords.get('POINTS'))
        else:
            try:
                x_min, y_min, w, h = (int(float(region.get(a)))
                                      for a in ('HPOS', 'VPOS', 'WIDTH', 'HEIGHT'))
                boundary = [(x_min, y_min), (x_min, y_min + h),
                            (x_min + w, y_min + h), (x_min + w, y_min)]
            except (ValueError, TypeError):
                pass
        has_coords = boundary is not None

        reg_tags = _resolve_tagrefs(tag_map, region.get('TAGREFS'), tag_set)
        tag_type = reg_tags.pop('region', None) or reg_tags.pop('type', None)
        if (rtype := region.get('TYPE')) is not None:
            rtype = [{'type': rtype}]
        else:
            rtype = tag_type or [{'type': ALTO_REGIONS[region.tag.split('}')[-1]]}]
        reg_tags['type'] = rtype

        region_lang = _element_langs(region, tag_map, tag_set,
                                     [page_lang] if page_lang is not None else None)
        if has_coords:
            region_data[rtype[0]['type']].append(Region(id=region_id, boundary=boundary,
                                                        tags=reg_tags, language=region_lang))
            region_implicit.append(region_id)
        else:
            missing_region_ids.add(region_id)

        for line in region.iterfind('./{*}TextLine'):
            line_id = line.get('ID')
            baseline = boundary_l = bbox = None
            if linetype == 'baselines':
                try:
                    baseline = parse_alto_pointstype(line.get('BASELINE'))
                except ValueError:
                    logger.info(f'TextLine {line_id} without baseline')
                    continue
                try:
                    pol = line.find('./{*}Shape/{*}Polygon')
                    boundary_l = parse_alto_pointstype(pol.get('POINTS'))
                except (ValueError, AttributeError):
                    logger.info(f'TextLine {line_id} without polygon')
            else:
                try:
                    x_min, y_min, w, h = (int(float(line.get(a)))
                                          for a in ('HPOS', 'VPOS', 'WIDTH', 'HEIGHT'))
                    bbox = (x_min, y_min, x_min + w, y_min + h)
                except (ValueError, TypeError):
                    logger.info(f'TextLine {line_id} missing full bounding box attributes.')
                    continue

            text = ''
            for el in line.xpath(".//*[local-name() = 'String'] | .//*[local-name() = 'SP']"):
                text += el.get('CONTENT') if el.get('CONTENT') else ' '
            for string_el in line.iterfind('./{*}String'):
                if (sid := string_el.get('ID')):
                    string_to_line[sid] = line_id

            line_tags = _resolve_tagrefs(tag_map, line.get('TAGREFS'), tag_set)
            line_langs = _element_langs(line, tag_map, tag_set, region_lang)
            line_split = None
            if (split := line_tags.get('split')) is not None and len(split) == 1:
                line_split = split[0]['type']
                line_tags.pop('split')
            line_dir = base_direction(line.get('BASEDIRECTION')) or region_dir

            common = dict(id=line_id,
                          text=text,
                          tags=line_tags if line_tags else None,
                          language=line_langs,
                          split=line_split,
                          base_dir=line_dir,
                          regions=[region_id] if has_coords else [])
            if linetype == 'baselines':
                lines[line_id] = BaselineLine(baseline=baseline, boundary=boundary_l, **common)
            else:
                lines[line_id] = BBoxLine(bbox=bbox, **common)
            line_implicit.append(line_id)

    raw_orders = {}
    if (ro_el := doc.find('.//{*}ReadingOrder')) is not None:
        for group, raw, is_total in parse_reading_order_groups(ro_el, 'REF'):
            ro_tags = _resolve_tagrefs(tag_map, group.get('TAGREFS'), tag_set)
            raw_orders[group.get('ID')] = {'order': raw,
                                           'is_total': is_total,
                                           'description': ro_tags.get('type', '')}

    return {'imagename': imagename,
            'image_size': image_size,
            'regions': dict(region_data),
            'lines': lines,
            'line_implicit_order': line_implicit,
            'region_implicit_order': region_implicit,
            'tag_set': tag_set,
            'raw_orders': raw_orders,
            'string_to_line_map': string_to_line,
            'missing_region_ids': missing_region_ids}
