"""
kraken_tpu_torch.lib.iso_names
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

ISO 15924 script-code and ISO 639-3 language-code display names for the
`kraken show` metadata renderer (reference behavior:
kraken/kraken.py:651-724, which delegates to htrmopo.util's full tables),
copied from the JAX package's ``lib/iso_names.py``.

The htrmopo package carries the complete registries and is preferred when
installed; offline, a curated table of the codes appearing in published
HTR/OCR model metadata is used, and unknown codes fall back to the code
itself — `show` output stays total either way.
"""
from typing import Optional

__all__ = ['iso15924_to_name', 'iso639_3_to_name']

# ISO 15924 four-letter script codes → English names (registry subset:
# the scripts with published kraken/HTR models plus the major living and
# scholarly scripts).
_ISO15924 = {
    'Adlm': 'Adlam', 'Arab': 'Arabic', 'Aran': 'Arabic (Nastaliq variant)',
    'Armn': 'Armenian', 'Avst': 'Avestan', 'Bali': 'Balinese',
    'Beng': 'Bengali', 'Bopo': 'Bopomofo', 'Brah': 'Brahmi',
    'Cher': 'Cherokee', 'Copt': 'Coptic', 'Cprt': 'Cypriot syllabary',
    'Cyrl': 'Cyrillic', 'Cyrs': 'Cyrillic (Old Church Slavonic variant)',
    'Deva': 'Devanagari', 'Dsrt': 'Deseret', 'Egyp': 'Egyptian hieroglyphs',
    'Ethi': 'Ethiopic', 'Geor': 'Georgian', 'Glag': 'Glagolitic',
    'Goth': 'Gothic', 'Gran': 'Grantha', 'Grek': 'Greek',
    'Gujr': 'Gujarati', 'Guru': 'Gurmukhi', 'Hang': 'Hangul',
    'Hani': 'Han (Hanzi, Kanji, Hanja)', 'Hans': 'Han (Simplified variant)',
    'Hant': 'Han (Traditional variant)', 'Hebr': 'Hebrew',
    'Hira': 'Hiragana', 'Hung': 'Old Hungarian', 'Ital': 'Old Italic',
    'Java': 'Javanese', 'Jpan': 'Japanese', 'Kana': 'Katakana',
    'Khmr': 'Khmer', 'Knda': 'Kannada', 'Kore': 'Korean',
    'Laoo': 'Lao', 'Latf': 'Latin (Fraktur variant)',
    'Latg': 'Latin (Gaelic variant)', 'Latn': 'Latin',
    'Mand': 'Mandaic, Mandaean', 'Mani': 'Manichaean',
    'Mlym': 'Malayalam', 'Mong': 'Mongolian', 'Mymr': 'Myanmar (Burmese)',
    'Narb': 'Old North Arabian', 'Nkoo': 'N’Ko', 'Ogam': 'Ogham',
    'Orkh': 'Old Turkic, Orkhon Runic', 'Orya': 'Oriya (Odia)',
    'Osma': 'Osmanya', 'Phag': 'Phags-pa', 'Phnx': 'Phoenician',
    'Plrd': 'Miao (Pollard)', 'Prti': 'Inscriptional Parthian',
    'Rohg': 'Hanifi Rohingya', 'Runr': 'Runic', 'Samr': 'Samaritan',
    'Sarb': 'Old South Arabian', 'Sgnw': 'SignWriting',
    'Sinh': 'Sinhala', 'Sogd': 'Sogdian', 'Sora': 'Sora Sompeng',
    'Soyo': 'Soyombo', 'Sund': 'Sundanese', 'Sylo': 'Syloti Nagri',
    'Syrc': 'Syriac', 'Syre': 'Syriac (Estrangelo variant)',
    'Syrj': 'Syriac (Western variant)', 'Syrn': 'Syriac (Eastern variant)',
    'Tale': 'Tai Le', 'Taml': 'Tamil', 'Tang': 'Tangut',
    'Telu': 'Telugu', 'Tfng': 'Tifinagh (Berber)', 'Tglg': 'Tagalog',
    'Thaa': 'Thaana', 'Thai': 'Thai', 'Tibt': 'Tibetan',
    'Ugar': 'Ugaritic', 'Vaii': 'Vai', 'Xpeo': 'Old Persian',
    'Xsux': 'Cuneiform, Sumero-Akkadian', 'Yezi': 'Yezidi', 'Yiii': 'Yi',
    'Zmth': 'Mathematical notation', 'Zsym': 'Symbols',
    'Zxxx': 'Code for unwritten documents', 'Zyyy': 'Code for undetermined script',
}

# ISO 639-3 language codes → English names (subset: languages of published
# HTR models and major languages; unknown codes fall back to the code).
_ISO639_3 = {
    'afr': 'Afrikaans', 'akk': 'Akkadian', 'amh': 'Amharic',
    'ang': 'Old English (ca. 450-1100)', 'ara': 'Arabic',
    'arc': 'Official Aramaic (700-300 BCE)', 'arz': 'Egyptian Arabic',
    'bel': 'Belarusian', 'ben': 'Bengali', 'bod': 'Tibetan',
    'bul': 'Bulgarian', 'cat': 'Catalan', 'ces': 'Czech',
    'chu': 'Church Slavic', 'ckb': 'Central Kurdish', 'cop': 'Coptic',
    'cym': 'Welsh', 'dan': 'Danish', 'deu': 'German',
    'dum': 'Middle Dutch (ca. 1050-1350)', 'ell': 'Modern Greek (1453-)',
    'eng': 'English', 'enm': 'Middle English (1100-1500)',
    'epo': 'Esperanto', 'est': 'Estonian', 'eus': 'Basque',
    'fao': 'Faroese', 'fas': 'Persian', 'fin': 'Finnish',
    'fra': 'French', 'frm': 'Middle French (ca. 1400-1600)',
    'fro': 'Old French (842-ca. 1400)', 'gle': 'Irish', 'glg': 'Galician',
    'gmh': 'Middle High German (ca. 1050-1500)',
    'goh': 'Old High German (ca. 750-1050)', 'got': 'Gothic',
    'grc': 'Ancient Greek (to 1453)', 'guj': 'Gujarati',
    'heb': 'Hebrew', 'hin': 'Hindi', 'hrv': 'Croatian',
    'hun': 'Hungarian', 'hye': 'Armenian', 'ind': 'Indonesian',
    'isl': 'Icelandic', 'ita': 'Italian', 'jpn': 'Japanese',
    'kan': 'Kannada', 'kat': 'Georgian', 'kaz': 'Kazakh',
    'khm': 'Khmer', 'kir': 'Kirghiz', 'kor': 'Korean',
    'kur': 'Kurdish', 'lad': 'Ladino', 'lao': 'Lao',
    'lat': 'Latin', 'lav': 'Latvian', 'lit': 'Lithuanian',
    'mal': 'Malayalam', 'mar': 'Marathi', 'mkd': 'Macedonian',
    'mlt': 'Maltese', 'mon': 'Mongolian', 'mya': 'Burmese',
    'nep': 'Nepali', 'nld': 'Dutch', 'nno': 'Norwegian Nynorsk',
    'nob': 'Norwegian Bokmål', 'non': 'Old Norse', 'nor': 'Norwegian',
    'oci': 'Occitan (post 1500)', 'ota': 'Ottoman Turkish (1500-1928)',
    'pan': 'Panjabi', 'pes': 'Iranian Persian', 'pli': 'Pali',
    'pol': 'Polish', 'por': 'Portuguese', 'pus': 'Pushto',
    'ron': 'Romanian', 'rus': 'Russian', 'san': 'Sanskrit',
    'sin': 'Sinhala', 'slk': 'Slovak', 'slv': 'Slovenian',
    'spa': 'Spanish', 'sqi': 'Albanian', 'srp': 'Serbian',
    'swa': 'Swahili (macrolanguage)', 'swe': 'Swedish',
    'syc': 'Classical Syriac', 'syr': 'Syriac', 'tam': 'Tamil',
    'tel': 'Telugu', 'tgk': 'Tajik', 'tha': 'Thai', 'tir': 'Tigrinya',
    'tur': 'Turkish', 'uig': 'Uighur', 'ukr': 'Ukrainian',
    'urd': 'Urdu', 'uzb': 'Uzbek', 'vie': 'Vietnamese',
    'yid': 'Yiddish', 'zho': 'Chinese',
}


def iso15924_to_name(code: Optional[str]) -> str:
    """Resolves an ISO 15924 script code to its English name; prefers the
    full htrmopo registry when installed, falls back to the curated table,
    then to the code itself."""
    if not code:
        return ''
    try:
        from htrmopo.util import iso15924_to_name as _full
        return _full(code)
    except Exception:
        pass
    return _ISO15924.get(code, code)


def iso639_3_to_name(code: Optional[str]) -> str:
    """Resolves an ISO 639-3 language code to its English name; prefers the
    full htrmopo registry when installed, falls back to the curated table,
    then to the code itself."""
    if not code:
        return ''
    try:
        from htrmopo.util import iso639_3_to_name as _full
        return _full(code)
    except Exception:
        pass
    return _ISO639_3.get(code, code)
