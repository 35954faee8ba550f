"""
kraken_tpu_torch.xml
~~~~~~~~~~~~~~~~~~~~

ALTO / PageXML facsimile parsing (reference: kraken/lib/xml). `XMLPage`
auto-detects the dialect, extracts regions/lines with tags, languages,
splits and base directions, resolves implicit and explicit reading orders
(ALTO ReadingOrder groups, PageXML OrderedGroup/UnorderedGroup, Transkribus
`custom` attribute orders), and converts to a
:class:`kraken_tpu_torch.containers.Segmentation`.
"""
import logging
from pathlib import Path
from typing import TYPE_CHECKING, Any, Literal, Optional, Union

from lxml import etree

from kraken_tpu_torch.containers import Segmentation
from kraken_tpu_torch.xml.common import (ALTO_REGIONS, PAGE_REGIONS,
                                         flatten_order_to_lines,
                                         flatten_order_to_regions,
                                         validate_and_clean_order)
from kraken_tpu_torch.xml.alto import parse_alto
from kraken_tpu_torch.xml.page import parse_page

logger = logging.getLogger(__name__)

if TYPE_CHECKING:
    from os import PathLike

__all__ = ['XMLPage']

# aliases matching the reference's public names
alto_regions = ALTO_REGIONS
page_regions = PAGE_REGIONS


class XMLPage:
    """
    Parses an XML facsimile in ALTO or PageXML format. Data below the line
    level is discarded.

    Args:
        filename: path to the XML file
        filetype: 'xml' (auto-detect), 'alto', or 'page'
        linetype: parse lines as 'baselines' or 'bbox'

    Attributes:
        type: line record type
        imagename: path of the facsimile image
        image_size: (width, height)
        has_tags: True when the document carries tag information
    """
    type: Literal['baselines', 'bbox'] = 'baselines'
    base_dir: Optional[Literal['L', 'R']] = None

    def __init__(self,
                 filename: Union[str, 'PathLike'],
                 filetype: Literal['xml', 'alto', 'page'] = 'xml',
                 linetype: Literal['baselines', 'bbox'] = 'baselines'):
        self.filename = Path(filename)
        self.filetype = filetype
        self.type = linetype
        self.imagename = None
        self.image_size = None
        self.has_tags = False
        self.has_splits = False
        self._split_set: Optional[list] = None
        self._tag_set: Optional[set] = None
        self._regions: dict = {}
        self._lines: dict = {}
        self._orders: dict[str, dict[str, Any]] = {
            'line_implicit': {'order': [], 'is_total': True,
                              'description': 'Line order implied by document element sequence',
                              'level': 'line'},
            'region_implicit': {'order': [], 'is_total': True,
                                'description': 'Region order implied by document element sequence',
                                'level': 'region'},
        }
        try:
            with open(self.filename, 'rb') as fp:
                doc = etree.parse(fp)
        except etree.XMLSyntaxError as e:
            raise ValueError(f'Parsing {self.filename} failed: {e}')
        root_tag = doc.getroot().tag
        if filetype == 'alto' or (filetype == 'xml' and root_tag.endswith('alto')):
            self._ingest(parse_alto(doc, self.filename, self.type), 'alto')
        elif filetype == 'page' or (filetype == 'xml' and root_tag.endswith('PcGts')):
            self._ingest(parse_page(doc, self.filename, self.type), 'page')
        else:
            raise ValueError(f'Unknown XML format in {self.filename}')

    def _ingest(self, result: dict, filetype: str) -> None:
        """Installs a parser result and flattens explicit reading orders."""
        self.imagename = result['imagename']
        self.image_size = result['image_size']
        self._regions = result['regions']
        self._lines = result['lines']
        self._tag_set = result['tag_set']
        self._orders['line_implicit']['order'] = result['line_implicit_order']
        self._orders['region_implicit']['order'] = result['region_implicit_order']
        self._orders.update(result.get('transkribus_orders', {}))

        region_ids = {reg.id for regs in self._regions.values() for reg in regs}
        missing_region_ids = set(result.get('missing_region_ids', set()))
        string_map = result.get('string_to_line_map')

        for ro_id, ro in result.get('raw_orders', {}).items():
            flat_lines = flatten_order_to_lines(ro['order'], self._lines, region_ids,
                                                result['line_implicit_order'],
                                                string_map, missing_region_ids)
            flat_lines, _ = validate_and_clean_order(flat_lines, set(self._lines.keys()))
            self._orders[ro_id] = {'order': flat_lines,
                                   'is_total': ro['is_total'],
                                   'description': ro['description'],
                                   'level': 'line'}
            flat_regions = flatten_order_to_regions(ro['order'], self._lines, region_ids,
                                                    string_map, missing_region_ids)
            flat_regions, _ = validate_and_clean_order(flat_regions, region_ids)
            self._orders[f'{ro_id}:regions'] = {'order': flat_regions,
                                                'is_total': ro['is_total'],
                                                'description': ro['description'],
                                                'level': 'region'}
        self.has_tags = len(self._tag_set) > 1
        self.filetype = filetype

    # ------------------------------------------------------------ accessors
    @property
    def regions(self):
        return self._regions

    @property
    def lines(self):
        return self._lines

    @property
    def reading_orders(self):
        return self._orders

    @property
    def tags(self):
        return self._tag_set

    @property
    def splits(self):
        return self._split_set

    def get_sorted_lines(self, ro: str = 'line_implicit'):
        """Lines in the given reading order."""
        if ro not in self._orders:
            raise ValueError(f'Unknown reading order {ro}')
        return [self._lines[lid] for lid in self._orders[ro]['order'] if lid in self._lines]

    def get_sorted_regions(self, ro: str = 'region_implicit'):
        """Regions in the given reading order."""
        if ro not in self._orders:
            raise ValueError(f'Unknown reading order {ro}')
        region_map = {reg.id: reg for regs in self._regions.values() for reg in regs}
        return [region_map[rid] for rid in self._orders[ro]['order'] if rid in region_map]

    def get_sorted_lines_by_region(self, region: str, ro: str = 'line_implicit'):
        """Lines contained in `region`, in the given (total) reading order."""
        if ro not in self._orders:
            raise ValueError(f'Unknown reading order {ro}')
        if self._orders[ro]['is_total'] is False:
            raise ValueError('Cannot fetch lines by region for a partial reading order')
        region_lines = [ln for ln in self._lines.values() if ln.regions and ln.regions[0] == region]
        order = self._orders[ro]['order']
        for ln in region_lines:
            if ln.id not in order:
                raise ValueError('Lines-by-region requires a flat (unnested) reading order')
        return sorted(region_lines, key=lambda ln: order.index(ln.id))

    def get_lines_by_tag(self, key, value):
        return {k: v for k, v in self._lines.items() if v.tags.get(key) == value}

    def get_lines_by_split(self, split: Literal['train', 'validation', 'test']):
        return {k: v for k, v in self._lines.items() if v.tags.get('split') == split}

    def __str__(self):
        return f'XMLPage {self.filename} (format: {self.filetype}, image: {self.imagename})'

    def __repr__(self):
        return f'XMLPage(filename={self.filename}, filetype={self.filetype})'

    def to_container(self) -> Segmentation:
        """Converts the page into a Segmentation container."""
        sorted_lines = self.get_sorted_lines()
        line_idx = {line.id: idx for idx, line in enumerate(sorted_lines)}
        line_orders = []
        for ro in self._orders.values():
            if ro['level'] != 'line':
                continue
            indices = [line_idx[lid] for lid in ro['order'] if lid in line_idx]
            if indices:
                line_orders.append(indices)
        return Segmentation(type=self.type,
                            imagename=self.imagename,
                            text_direction='horizontal-lr',
                            script_detection=True,
                            lines=sorted_lines,
                            regions=self._regions,
                            line_orders=line_orders)
