#
# Copyright 2026 The kraken_tpu authors
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or
# implied.  See the License for the specific language governing
# permissions and limitations under the License.
"""
Dependency-free extraction of scanned page images from PDF files.

The reference rasterizes PDF pages through pyvips at a fixed 300 dpi
(``kraken/kraken.py:363-399``).  For *scanned* documents —
the dominant OCR input — every page is a single embedded raster image, so
rasterization is both lossy (resampling at an arbitrary dpi) and an
unnecessary native dependency.  This module parses the PDF container
directly and hands back the embedded page images at their native
resolution.  It is used as the fallback backend of ``kraken -f pdf`` when
neither pyvips nor PyMuPDF is installed; born-digital (vector-text) PDFs
still need one of those rasterizers and raise :class:`PDFError` with a
clear message.

Supported container features: classic xref tables, cross-reference
streams, object streams (PDF 1.5+), hybrid-reference files, incremental
updates, and the stream filters FlateDecode (with PNG/TIFF predictors),
LZWDecode, RunLengthDecode, ASCIIHexDecode and ASCII85Decode.  Image
XObjects are decoded from DCTDecode (JPEG), JPXDecode (JPEG 2000),
CCITTFaxDecode (wrapped into an in-memory TIFF for Pillow's fax decoder)
and raw bitmaps in the DeviceGray/RGB/CMYK, ICCBased and Indexed colour
spaces at 1/8/16 bits per component.

A copy of the JAX package's ``lib/pdf.py`` (standard library and PIL only).
"""
import io
import logging
import re
import struct
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

logger = logging.getLogger(__name__)

__all__ = ['PDFError', 'extract_page_images', 'page_count']


class PDFError(Exception):
    """Raised when a PDF cannot be parsed or a page has no raster image."""


class _Ref:
    __slots__ = ('num', 'gen')

    def __init__(self, num: int, gen: int):
        self.num = num
        self.gen = gen

    def __repr__(self):
        return f'{self.num} {self.gen} R'


class _Stream:
    __slots__ = ('dict', 'raw')

    def __init__(self, d: Dict[str, Any], raw: bytes):
        self.dict = d
        self.raw = raw


_WHITESPACE = b'\x00\t\n\x0c\r '
_DELIMITERS = b'()<>[]{}/%'


class _Lexer:
    """Tokenizer/parser for the PDF object syntax (ISO 32000-1 §7.3)."""

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def _skip_ws(self):
        buf, n = self.buf, len(self.buf)
        while self.pos < n:
            c = buf[self.pos]
            if c in _WHITESPACE:
                self.pos += 1
            elif c == 0x25:  # '%' comment to EOL
                while self.pos < n and buf[self.pos] not in b'\r\n':
                    self.pos += 1
            else:
                break

    def parse(self) -> Any:
        self._skip_ws()
        buf = self.buf
        if self.pos >= len(buf):
            raise PDFError('unexpected end of data')
        c = buf[self.pos]
        if c == 0x2f:                      # /Name
            return self._parse_name()
        if buf.startswith(b'<<', self.pos):
            return self._parse_dict()
        if c == 0x3c:                      # <hex string>
            return self._parse_hex_string()
        if c == 0x28:                      # (literal string)
            return self._parse_string()
        if c == 0x5b:                      # [array]
            return self._parse_array()
        if buf.startswith(b'true', self.pos):
            self.pos += 4
            return True
        if buf.startswith(b'false', self.pos):
            self.pos += 5
            return False
        if buf.startswith(b'null', self.pos):
            self.pos += 4
            return None
        return self._parse_number_or_ref()

    def _parse_name(self) -> str:
        buf, n = self.buf, len(self.buf)
        self.pos += 1
        out = bytearray()
        while self.pos < n:
            c = buf[self.pos]
            if c in _WHITESPACE or c in _DELIMITERS:
                break
            if c == 0x23 and self.pos + 2 < n:  # '#xx'
                out.append(int(buf[self.pos + 1:self.pos + 3], 16))
                self.pos += 3
            else:
                out.append(c)
                self.pos += 1
        return out.decode('latin-1')

    def _parse_dict(self) -> Dict[str, Any]:
        self.pos += 2
        d: Dict[str, Any] = {}
        while True:
            self._skip_ws()
            if self.buf.startswith(b'>>', self.pos):
                self.pos += 2
                return d
            key = self.parse()
            if not isinstance(key, str):
                raise PDFError(f'dictionary key is not a name: {key!r}')
            d[key] = self.parse()

    def _parse_array(self) -> List[Any]:
        self.pos += 1
        arr: List[Any] = []
        while True:
            self._skip_ws()
            if self.pos < len(self.buf) and self.buf[self.pos] == 0x5d:
                self.pos += 1
                return arr
            arr.append(self.parse())

    def _parse_hex_string(self) -> bytes:
        end = self.buf.index(b'>', self.pos)
        hx = bytes(c for c in self.buf[self.pos + 1:end] if c not in _WHITESPACE)
        self.pos = end + 1
        if len(hx) % 2:
            hx += b'0'
        return bytes.fromhex(hx.decode('ascii'))

    def _parse_string(self) -> bytes:
        buf, n = self.buf, len(self.buf)
        self.pos += 1
        out = bytearray()
        depth = 1
        while self.pos < n:
            c = buf[self.pos]
            if c == 0x5c:  # backslash escape
                self.pos += 1
                e = buf[self.pos]
                esc = {0x6e: 0x0a, 0x72: 0x0d, 0x74: 0x09, 0x62: 0x08,
                       0x66: 0x0c}
                if e in esc:
                    out.append(esc[e])
                    self.pos += 1
                elif 0x30 <= e <= 0x37:  # octal
                    oct_s = bytearray()
                    while len(oct_s) < 3 and 0x30 <= buf[self.pos] <= 0x37:
                        oct_s.append(buf[self.pos])
                        self.pos += 1
                    out.append(int(oct_s, 8) & 0xff)
                elif e in b'\r\n':  # line continuation
                    self.pos += 1
                    if e == 0x0d and buf[self.pos] == 0x0a:
                        self.pos += 1
                else:
                    out.append(e)
                    self.pos += 1
            elif c == 0x28:
                depth += 1
                out.append(c)
                self.pos += 1
            elif c == 0x29:
                depth -= 1
                if depth == 0:
                    self.pos += 1
                    return bytes(out)
                out.append(c)
                self.pos += 1
            else:
                out.append(c)
                self.pos += 1
        raise PDFError('unterminated string')

    _NUM_RE = re.compile(rb'[+-]?\d*\.?\d+')
    _REF_RE = re.compile(rb'(\d+)[\x00\t\n\x0c\r ]+(\d+)[\x00\t\n\x0c\r ]+R(?![a-zA-Z])')

    def _parse_number_or_ref(self) -> Union[int, float, _Ref]:
        m = self._REF_RE.match(self.buf, self.pos)
        if m:
            self.pos = m.end()
            return _Ref(int(m.group(1)), int(m.group(2)))
        m = self._NUM_RE.match(self.buf, self.pos)
        if not m:
            snippet = self.buf[self.pos:self.pos + 20]
            raise PDFError(f'cannot parse object at {self.pos}: {snippet!r}')
        self.pos = m.end()
        tok = m.group(0)
        return float(tok) if b'.' in tok else int(tok)


def _apply_predictor(data: bytes, parms: Dict[str, Any]) -> bytes:
    pred = parms.get('Predictor', 1)
    if pred <= 1:
        return data
    colors = parms.get('Colors', 1)
    bpc = parms.get('BitsPerComponent', 8)
    columns = parms.get('Columns', 1)
    bpp = max(1, (colors * bpc) // 8)
    rowlen = (columns * colors * bpc + 7) // 8
    if pred == 2:  # TIFF horizontal differencing (8-bit components only)
        out = bytearray(data)
        for r in range(0, len(out), rowlen):
            for i in range(r + bpp, min(r + rowlen, len(out))):
                out[i] = (out[i] + out[i - bpp]) & 0xff
        return bytes(out)
    # PNG predictors: each row prefixed with a filter-type byte
    out = bytearray()
    prev = bytearray(rowlen)
    pos = 0
    while pos + 1 <= len(data):
        ft = data[pos]
        row = bytearray(data[pos + 1:pos + 1 + rowlen])
        pos += 1 + rowlen
        if ft == 1:    # Sub
            for i in range(bpp, len(row)):
                row[i] = (row[i] + row[i - bpp]) & 0xff
        elif ft == 2:  # Up
            for i in range(len(row)):
                row[i] = (row[i] + prev[i]) & 0xff
        elif ft == 3:  # Average
            for i in range(len(row)):
                left = row[i - bpp] if i >= bpp else 0
                row[i] = (row[i] + ((left + prev[i]) >> 1)) & 0xff
        elif ft == 4:  # Paeth
            for i in range(len(row)):
                a = row[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pr = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                row[i] = (row[i] + pr) & 0xff
        out += row
        prev = row
    return bytes(out)


def _lzw_decode(data: bytes, early_change: int = 1) -> bytes:
    """TIFF-variant LZW with 9→12-bit codes and EarlyChange (§7.4.4.2)."""
    out = bytearray()
    table: List[bytes] = [bytes([i]) for i in range(256)] + [b'', b'']
    width = 9
    prev: Optional[bytes] = None
    acc = nbits = 0
    for byte in data:
        acc = (acc << 8) | byte
        nbits += 8
        while nbits >= width:
            code = (acc >> (nbits - width)) & ((1 << width) - 1)
            nbits -= width
            if code == 256:  # clear table
                table = table[:258]
                width = 9
                prev = None
                continue
            if code == 257:  # EOD
                return bytes(out)
            if prev is None:
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            else:
                entry = prev + prev[:1]
                table.append(entry)
            out += entry
            prev = entry
            if len(table) + early_change >= (1 << width) and width < 12:
                width += 1
    return bytes(out)


def _rle_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        ln = data[i]
        if ln == 128:
            break
        if ln < 128:
            out += data[i + 1:i + 2 + ln]
            i += 2 + ln
        else:
            out += data[i + 1:i + 2] * (257 - ln)
            i += 2
    return bytes(out)


# filters whose output is an encoded image handed to Pillow, not bytes
_IMAGE_FILTERS = {'DCTDecode', 'DCT', 'JPXDecode', 'CCITTFaxDecode', 'CCF',
                  'JBIG2Decode'}


def _decode_stream(stream: _Stream, resolve) -> Tuple[bytes, Optional[str], Dict[str, Any]]:
    """Runs the filter chain; stops at an image-terminal filter.

    Returns (data, terminal_image_filter_or_None, terminal_decode_parms).
    """
    d = stream.dict
    filters = resolve(d.get('Filter', []))
    if isinstance(filters, (str,)):
        filters = [filters]
    parms = resolve(d.get('DecodeParms', d.get('DP', [])))
    if isinstance(parms, dict) or parms is None:
        parms = [parms]
    parms = list(parms) + [None] * (len(filters) - len(parms))
    data = stream.raw
    for i, f in enumerate(filters):
        f = resolve(f)
        p = resolve(parms[i]) or {}
        p = {k: resolve(v) for k, v in p.items()}
        if f in _IMAGE_FILTERS:
            if i != len(filters) - 1:
                raise PDFError(f'image filter {f} is not the terminal filter')
            return data, f, p
        if f in ('FlateDecode', 'Fl'):
            try:
                data = zlib.decompress(data)
            except zlib.error:
                # tolerate trailing garbage / missing checksums
                dec = zlib.decompressobj()
                data = dec.decompress(data)
            data = _apply_predictor(data, p)
        elif f in ('LZWDecode', 'LZW'):
            data = _lzw_decode(data, p.get('EarlyChange', 1))
            data = _apply_predictor(data, p)
        elif f in ('RunLengthDecode', 'RL'):
            data = _rle_decode(data)
        elif f in ('ASCIIHexDecode', 'AHx'):
            hx = bytes(c for c in data if c not in _WHITESPACE + b'>')
            if len(hx) % 2:
                hx += b'0'
            data = bytes.fromhex(hx.decode('ascii'))
        elif f in ('ASCII85Decode', 'A85'):
            import base64
            txt = bytes(c for c in data if c not in _WHITESPACE)
            if txt.endswith(b'~>'):
                txt = txt[:-2]
            data = base64.a85decode(txt)
        else:
            raise PDFError(f'unsupported stream filter {f}')
    return data, None, {}


class _Document:
    """Random-access PDF object store (xref tables/streams + ObjStm)."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.entries: Dict[int, Tuple] = {}   # num -> ('n', offset) | ('s', container, idx)
        self.trailer: Dict[str, Any] = {}
        self._cache: Dict[int, Any] = {}
        self._objstm_cache: Dict[int, Tuple[bytes, Dict[int, int]]] = {}
        self._load_xrefs()
        if 'Encrypt' in self.trailer:
            raise PDFError('encrypted PDFs are not supported — decrypt the '
                           'file first (e.g. qpdf --decrypt)')

    # -- cross-reference machinery ------------------------------------
    def _load_xrefs(self):
        tail = self.buf[-2048:]
        m = None
        for m in re.finditer(rb'startxref\s+(\d+)', tail):
            pass
        if m is None:
            # damaged file: scan for objects directly
            logger.warning('PDF has no startxref; scanning for objects')
            self._scan_all_objects()
            return
        offset = int(m.group(1))
        seen = set()
        while offset and offset not in seen:
            seen.add(offset)
            try:
                trailer = self._load_xref_section(offset)
            except PDFError as e:
                logger.warning(f'corrupt xref at {offset} ({e}); scanning')
                self._scan_all_objects()
                return
            if not self.trailer:
                self.trailer = trailer
            else:
                for k, v in trailer.items():
                    self.trailer.setdefault(k, v)
            # hybrid-reference file: the classic table's trailer points at
            # an additional xref stream with the compressed objects
            if 'XRefStm' in trailer:
                try:
                    self._load_xref_section(int(trailer['XRefStm']))
                except PDFError:
                    pass
            offset = trailer.get('Prev')
            offset = int(offset) if offset is not None else 0
        if 'Root' not in self.trailer:
            self._scan_all_objects()

    def _load_xref_section(self, offset: int) -> Dict[str, Any]:
        lex = _Lexer(self.buf, offset)
        lex._skip_ws()
        if self.buf.startswith(b'xref', lex.pos):
            return self._load_xref_table(lex.pos + 4)
        return self._load_xref_stream(offset)

    def _load_xref_table(self, pos: int) -> Dict[str, Any]:
        lex = _Lexer(self.buf, pos)
        while True:
            lex._skip_ws()
            if self.buf.startswith(b'trailer', lex.pos):
                lex.pos += 7
                trailer = lex.parse()
                if not isinstance(trailer, dict):
                    raise PDFError('trailer is not a dictionary')
                return trailer
            start = lex.parse()
            count = lex.parse()
            if not isinstance(start, int) or not isinstance(count, int):
                raise PDFError('malformed xref subsection header')
            lex._skip_ws()
            for i in range(count):
                entry = self.buf[lex.pos:lex.pos + 20]
                off, gen, kind = entry[:10], entry[11:16], entry[17:18]
                if kind == b'n' and (start + i) not in self.entries:
                    self.entries[start + i] = ('n', int(off))
                lex.pos += 20
                # tolerate 19-byte rows (single-byte EOL)
                if self.buf[lex.pos - 1:lex.pos] not in b'\r\n \x00':
                    lex.pos -= 1

    def _load_xref_stream(self, offset: int) -> Dict[str, Any]:
        obj = self._parse_object_at(offset)
        if not isinstance(obj, _Stream) or obj.dict.get('Type') != 'XRef':
            raise PDFError(f'no xref table or stream at offset {offset}')
        data, term, _ = _decode_stream(obj, self.resolve)
        if term:
            raise PDFError('xref stream uses an image filter')
        w = [int(x) for x in self.resolve(obj.dict['W'])]
        size = int(self.resolve(obj.dict['Size']))
        index = [int(x) for x in self.resolve(obj.dict.get('Index', [0, size]))]
        rowlen = sum(w)
        pos = 0

        def field(row, a, b):
            if b == 0:
                return 1 if (a, b) == (0, 0) else 0  # omitted type field defaults to 1
            return int.from_bytes(row[a:a + b], 'big')

        for k in range(0, len(index), 2):
            first, count = index[k], index[k + 1]
            for i in range(count):
                row = data[pos:pos + rowlen]
                pos += rowlen
                if len(row) < rowlen:
                    break
                typ = field(row, 0, w[0]) if w[0] else 1
                f2 = field(row, w[0], w[1])
                f3 = field(row, w[0] + w[1], w[2])
                num = first + i
                if num in self.entries:
                    continue
                if typ == 1:
                    self.entries[num] = ('n', f2)
                elif typ == 2:
                    self.entries[num] = ('s', f2, f3)
        return dict(obj.dict)

    def _scan_all_objects(self):
        """Last-resort recovery: regex-scan for `N G obj` headers."""
        for m in re.finditer(rb'(?m)^[\x00\t\n\x0c\r ]*(\d+)[\x00\t\n\x0c\r ]+(\d+)[\x00\t\n\x0c\r ]+obj\b',
                             self.buf):
            self.entries[int(m.group(1))] = ('n', m.start())
        if not self.trailer:
            m = None
            for m in re.finditer(rb'trailer', self.buf):
                pass
            if m:
                lex = _Lexer(self.buf, m.end())
                t = lex.parse()
                if isinstance(t, dict):
                    self.trailer = t
        if 'Root' not in self.trailer:
            # find the catalog by scanning
            for num in self.entries:
                obj = self.load(num)
                d = obj.dict if isinstance(obj, _Stream) else obj
                if isinstance(d, dict) and d.get('Type') == 'Catalog':
                    self.trailer['Root'] = _Ref(num, 0)
                    break
        if 'Root' not in self.trailer:
            raise PDFError('cannot locate document catalog')

    # -- object loading -----------------------------------------------
    def _parse_object_at(self, offset: int) -> Any:
        m = re.compile(rb'(\d+)[\x00\t\n\x0c\r ]+(\d+)[\x00\t\n\x0c\r ]+obj').match(self.buf, offset)
        if not m:
            # some writers emit slightly-off offsets; search nearby
            window = self.buf[max(0, offset - 32):offset + 64]
            m2 = re.search(rb'(\d+)[\x00\t\n\x0c\r ]+(\d+)[\x00\t\n\x0c\r ]+obj', window)
            if not m2:
                raise PDFError(f'no object at offset {offset}')
            m = m2
            offset = max(0, offset - 32) + m2.start()
            lex = _Lexer(self.buf, offset + len(m2.group(0)))
        else:
            lex = _Lexer(self.buf, m.end())
        obj = lex.parse()
        if isinstance(obj, dict):
            lex._skip_ws()
            if self.buf.startswith(b'stream', lex.pos):
                p = lex.pos + 6
                if self.buf[p:p + 2] == b'\r\n':
                    p += 2
                elif self.buf[p:p + 1] in (b'\n', b'\r'):
                    p += 1
                length = self.resolve(obj.get('Length'))
                if isinstance(length, int) and 0 <= length <= len(self.buf) - p:
                    raw = self.buf[p:p + length]
                    # validate; some writers emit wrong /Length
                    tailpos = p + length
                    if b'endstream' not in self.buf[tailpos:tailpos + 32]:
                        end = self.buf.find(b'endstream', p)
                        raw = self.buf[p:end].rstrip(b'\r\n')
                else:
                    end = self.buf.find(b'endstream', p)
                    if end < 0:
                        raise PDFError('unterminated stream')
                    raw = self.buf[p:end].rstrip(b'\r\n')
                return _Stream(obj, raw)
        return obj

    def _load_objstm(self, num: int) -> Tuple[bytes, Dict[int, int]]:
        if num in self._objstm_cache:
            return self._objstm_cache[num]
        container = self.load(num)
        if not isinstance(container, _Stream) or container.dict.get('Type') != 'ObjStm':
            raise PDFError(f'object {num} is not an object stream')
        data, term, _ = _decode_stream(container, self.resolve)
        if term:
            raise PDFError('object stream uses an image filter')
        n = int(self.resolve(container.dict['N']))
        first = int(self.resolve(container.dict['First']))
        lex = _Lexer(data, 0)
        offsets: Dict[int, int] = {}
        for _ in range(n):
            onum = lex.parse()
            ooff = lex.parse()
            offsets[int(onum)] = first + int(ooff)
        self._objstm_cache[num] = (data, offsets)
        return data, offsets

    def load(self, num: int) -> Any:
        if num in self._cache:
            return self._cache[num]
        entry = self.entries.get(num)
        if entry is None:
            return None
        if entry[0] == 'n':
            obj = self._parse_object_at(entry[1])
        else:
            data, offsets = self._load_objstm(entry[1])
            if num not in offsets:
                raise PDFError(f'object {num} missing from object stream {entry[1]}')
            obj = _Lexer(data, offsets[num]).parse()
        self._cache[num] = obj
        return obj

    def resolve(self, obj: Any) -> Any:
        depth = 0
        while isinstance(obj, _Ref):
            obj = self.load(obj.num)
            depth += 1
            if depth > 32:
                raise PDFError('reference cycle')
        return obj

    # -- page tree -----------------------------------------------------
    def pages(self) -> List[Dict[str, Any]]:
        """Flattened page dictionaries with inherited attributes resolved."""
        root = self.resolve(self.trailer['Root'])
        out: List[Dict[str, Any]] = []
        inheritable = ('Resources', 'MediaBox', 'Rotate')

        def walk(node_ref, inherited, depth):
            if depth > 64:
                raise PDFError('page tree too deep')
            node = self.resolve(node_ref)
            if not isinstance(node, dict):
                return
            inh = dict(inherited)
            for k in inheritable:
                if k in node:
                    inh[k] = node[k]
            if node.get('Type') == 'Page' or 'Kids' not in node:
                page = dict(inh)
                page.update(node)
                out.append(page)
                return
            for kid in self.resolve(node.get('Kids', [])):
                walk(kid, inh, depth + 1)
                if len(out) > 100000:
                    raise PDFError('implausible page count')

        walk(root['Pages'], {}, 0)
        return out


# ---------------------------------------------------------------- images

def _ccitt_to_tiff(data: bytes, width: int, height: int,
                   parms: Dict[str, Any]) -> bytes:
    """Wraps raw CCITT G3/G4 data into a single-strip TIFF for Pillow."""
    k = int(parms.get('K', 0))
    compression = 4 if k < 0 else 3
    black_is_1 = bool(parms.get('BlackIs1', False))
    # PDF default (BlackIs1 false): decoded 0 bits are black pixels.
    # TIFF photometric 0 = WhiteIsZero (0 is white), 1 = BlackIsZero.
    photometric = 1 if not black_is_1 else 0
    tags = [
        (256, 3, 1, width),         # ImageWidth
        (257, 3, 1, height),        # ImageLength
        (258, 3, 1, 1),             # BitsPerSample
        (259, 3, 1, compression),   # Compression
        (262, 3, 1, photometric),   # PhotometricInterpretation
        (273, 4, 1, 0),             # StripOffsets (patched below)
        (277, 3, 1, 1),             # SamplesPerPixel
        (278, 3, 1, height),        # RowsPerStrip
        (279, 4, 1, len(data)),     # StripByteCounts
    ]
    if compression == 3 and k > 0:
        tags.append((292, 4, 1, 1))  # T4Options: 2-D encoding
    strip_offset = 8 + 2 + 12 * len(tags) + 4
    tags = [(273, 4, 1, strip_offset) if t[0] == 273 else t for t in tags]
    out = bytearray(b'II*\x00' + struct.pack('<I', 8))
    out += struct.pack('<H', len(tags))
    for tag, typ, cnt, val in sorted(tags):
        out += struct.pack('<HHII', tag, typ, cnt, val)
    out += struct.pack('<I', 0)  # next IFD
    out += data
    return bytes(out)


def _raw_mode(doc: _Document, xobj: Dict[str, Any]) -> Tuple[str, str, Optional[bytes]]:
    """Maps a PDF colour space to (PIL mode, rawmode, palette_or_None)."""
    bpc = int(doc.resolve(xobj.get('BitsPerComponent', 8)))
    if doc.resolve(xobj.get('ImageMask', False)):
        return '1', '1', None  # stencil: sample 0 paints (black)
    cs = doc.resolve(xobj.get('ColorSpace', 'DeviceGray'))
    if isinstance(cs, list):
        family = doc.resolve(cs[0])
        if family == 'Indexed':
            base = doc.resolve(cs[1])
            lookup = doc.resolve(cs[3])
            if isinstance(lookup, _Stream):
                lookup, term, _ = _decode_stream(lookup, doc.resolve)
                if term:
                    raise PDFError('unsupported palette encoding')
            ncomp = 3
            if isinstance(base, list) and doc.resolve(base[0]) == 'ICCBased':
                ncomp = int(doc.resolve(doc.resolve(base[1]).dict.get('N', 3)))
            elif base in ('DeviceGray', 'CalGray'):
                ncomp = 1
            elif base == 'DeviceCMYK':
                raise PDFError('Indexed-over-CMYK colour space unsupported')
            if ncomp == 1:
                lookup = b''.join(bytes([v, v, v]) for v in lookup)
            rawmode = {1: 'P;1', 2: 'P;2', 4: 'P;4', 8: 'P'}[bpc]
            return 'P', rawmode, bytes(lookup)
        if family == 'ICCBased':
            n = int(doc.resolve(doc.resolve(cs[1]).dict.get('N', 1)))
            cs = {1: 'DeviceGray', 3: 'DeviceRGB', 4: 'DeviceCMYK'}[n]
        elif family in ('CalGray',):
            cs = 'DeviceGray'
        elif family in ('CalRGB', 'Lab'):
            cs = 'DeviceRGB'
        else:
            raise PDFError(f'unsupported colour space {family}')
    if cs in ('DeviceGray', 'CalGray'):
        if bpc == 1:
            return '1', '1', None
        if bpc == 16:
            return 'I;16B', 'I;16B', None
        return 'L', 'L', None
    if cs in ('DeviceRGB', 'CalRGB'):
        if bpc == 16:
            raise PDFError('16-bit RGB images unsupported')
        return 'RGB', 'RGB', None
    if cs == 'DeviceCMYK':
        return 'CMYK', 'CMYK', None  # PDF and PIL both use 0 = no ink
    raise PDFError(f'unsupported colour space {cs}')


def _decode_image(doc: _Document, xobj_stream: _Stream):
    from PIL import Image
    d = xobj_stream.dict
    width = int(doc.resolve(d['Width']))
    height = int(doc.resolve(d['Height']))
    data, term, parms = _decode_stream(xobj_stream, doc.resolve)
    if term in ('DCTDecode', 'DCT', 'JPXDecode'):
        im = Image.open(io.BytesIO(data))
        im.load()
        if im.mode == 'CMYK':
            im = im.convert('RGB')
        return im
    if term in ('CCITTFaxDecode', 'CCF'):
        cols = int(parms.get('Columns', 1728))
        rows = int(parms.get('Rows', height))
        tiff = _ccitt_to_tiff(data, cols, rows, parms)
        im = Image.open(io.BytesIO(tiff))
        im.load()
        return im.crop((0, 0, width, height)) if im.size != (width, height) else im
    if term == 'JBIG2Decode':
        raise PDFError('JBIG2-compressed images unsupported — rasterize with '
                       'pyvips or PyMuPDF')
    if term is not None:
        raise PDFError(f'unsupported image filter {term}')
    mode, rawmode, palette = _raw_mode(doc, d)
    bpc = int(doc.resolve(d.get('BitsPerComponent', 8)))
    ncomp = {'1': 1, 'L': 1, 'I;16B': 1, 'P': 1, 'RGB': 3, 'CMYK': 4}[mode]
    stride = (width * ncomp * bpc + 7) // 8
    need = stride * height
    if len(data) < need:
        raise PDFError(f'image data truncated ({len(data)} < {need} bytes)')
    if mode == 'I;16B':  # keep the high byte: 16-bit gray → 8-bit gray
        data = data[:need:2]
        mode, rawmode, stride = 'L', 'L', width
        need = stride * height
    im = Image.frombytes(mode, (width, height), bytes(data[:need]), 'raw',
                         rawmode, stride, 1)
    if palette is not None:
        im.putpalette(palette)
        im = im.convert('RGB')
    decode = doc.resolve(d.get('Decode'))
    if decode and list(decode[:2]) == [1, 0] and im.mode in ('1', 'L', 'RGB'):
        from PIL import ImageOps
        im = ImageOps.invert(im.convert('L') if im.mode == '1' else im)
    if im.mode == 'CMYK':
        im = im.convert('RGB')
    return im


def _page_images(doc: _Document, page: Dict[str, Any], depth: int = 0) -> List[_Stream]:
    """All image XObjects reachable from a page (incl. one level of Forms)."""
    out = []
    res = doc.resolve(page.get('Resources', {})) or {}
    xobjects = doc.resolve(res.get('XObject', {})) or {}
    for name, ref in xobjects.items():
        xo = doc.resolve(ref)
        if not isinstance(xo, _Stream):
            continue
        sub = doc.resolve(xo.dict.get('Subtype'))
        if sub == 'Image':
            out.append(xo)
        elif sub == 'Form' and depth < 3:
            out.extend(_page_images(doc, xo.dict, depth + 1))
    return out


def _open_document(path) -> _Document:
    buf = Path(path).read_bytes()
    if not buf.lstrip()[:5].startswith(b'%PDF-'):
        raise PDFError(f'{path} is not a PDF file')
    return _Document(buf)


def page_count(path) -> int:
    """Number of pages in the PDF at ``path``."""
    return len(_open_document(path).pages())


def _decode_page(doc, page, idx: int):
    """Decodes the dominant raster image of one parsed page (largest
    embedded XObject by pixel count, ``/Rotate`` applied)."""
    imgs = _page_images(doc, page)
    if not imgs:
        raise PDFError(
            f'page {idx} contains no embedded raster image; '
            'this looks like a born-digital PDF — install pyvips or '
            'PyMuPDF to rasterize it')
    sizes = [int(doc.resolve(x.dict['Width'])) * int(doc.resolve(x.dict['Height']))
             for x in imgs]
    best = max(range(len(imgs)), key=sizes.__getitem__)
    if len(imgs) > 1 and sorted(sizes)[-2] >= 0.2 * sizes[best]:
        logger.warning(f'page {idx}: multiple significant images; '
                       'extracting the largest only')
    im = _decode_image(doc, imgs[best])
    rotate = int(doc.resolve(page.get('Rotate', 0)) or 0) % 360
    if rotate:
        from PIL import Image
        im = im.transpose({90: Image.Transpose.ROTATE_270,
                           180: Image.Transpose.ROTATE_180,
                           270: Image.Transpose.ROTATE_90}[rotate])
    return im


def extract_page_images(path):
    """Yields one PIL image per page of a scanned PDF.

    For each page the largest embedded image XObject (by pixel count) is
    decoded at its native resolution and rotated according to the page's
    ``/Rotate`` attribute.  Pages without any raster image (born-digital
    PDFs) raise :class:`PDFError` — those need a real rasterizer
    (pyvips or PyMuPDF, as the reference uses:
    ``kraken/kraken.py:363-399``).
    """
    for thunk in extract_page_images_lazy(path):
        yield thunk()


def extract_page_images_lazy(path):
    """Yields one zero-argument callable per page; calling it parses and
    decodes that page's image (semantics of :func:`extract_page_images`
    otherwise). Feeding these callables to ``kraken_tpu_torch.pipeline
    .process_pages`` moves JPEG/Flate decoding into the prefetch pool,
    where it overlaps the recognition engine's device waits instead of
    stalling the page consumer."""
    doc = _open_document(path)
    pages = doc.pages()
    if not pages:
        raise PDFError(f'{path} contains no pages')
    for idx, page in enumerate(pages):
        yield lambda doc=doc, page=page, idx=idx: _decode_page(doc, page, idx)
