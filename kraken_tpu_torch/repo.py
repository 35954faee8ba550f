"""
kraken_tpu_torch.repo
~~~~~~~~~~~~~~~~~~~~~

Model repository client (reference: kraken/repo.py), the counterpart of the
JAX package's ``repo.py``: thin wrappers around the htrmopo Zenodo client
filtering for kraken-compatible records. Nothing here runs a model or
touches a device. The htrmopo package is optional; all entry points raise
a clear error when it is missing or the environment has no network access.
"""
import logging
from typing import Any, Optional

from kraken_tpu_torch.exceptions import KrakenRepoException

logger = logging.getLogger(__name__)

__all__ = ['get_description', 'get_listing', 'get_model', 'publish_model']


def _htrmopo():
    try:
        import htrmopo
        return htrmopo
    except ImportError as e:
        raise KrakenRepoException(
            'Model repository access requires the `htrmopo` package which is not '
            'installed in this environment.') from e


def _meta(record) -> dict[str, Any]:
    """Normalizes an htrmopo record (dataclass or dict) to a plain dict."""
    return dict(record) if isinstance(record, dict) else vars(record)


def _is_kraken_record(meta: dict[str, Any]) -> bool:
    """
    The kraken-record filter of the reference CLI
    (kraken/kraken.py:677, 756-760): a record qualifies when its
    software_name is 'kraken' OR it carries the 'kraken_pytorch' keyword
    (legacy records predate the software_name field).
    """
    return meta.get('software_name') == 'kraken' or \
        'kraken_pytorch' in (meta.get('keywords') or ())


def get_description(model_id: str, version: Optional[str] = None,
                    callback=lambda: None) -> dict[str, Any]:
    """
    Fetches the metadata record of a model, raising when the record exists
    but is not a kraken model (reference: kraken/repo.py:36-52).
    """
    mopo = _htrmopo()
    desc = mopo.get_description(model_id, callback=callback, version=version)
    meta = _meta(desc)
    if not _is_kraken_record(meta):
        raise KrakenRepoException(f'Record {model_id} exists but is not a kraken-compatible model')
    return meta


def get_listing(model_type: str = 'all', language=None, script=None,
                keyword=None, callback=lambda total, advance: None) -> dict[str, Any]:
    """
    Lists kraken-compatible records in the repository grouped by concept
    DOI, retaining the newest matching deposit per concept (reference:
    kraken/repo.py:55-87 groups by concept_doi preferring the v1 metadata
    schema and sorting versions by publication date; kraken/kraken.py:748-773
    applies the type/script/language/keyword filters and displays the
    newest).

    htrmopo's listing maps record DOIs to per-schema-version records
    ({'v0': record, 'v1': record}); plain record values are accepted too.
    """
    return {concept_id: versions[0]
            for concept_id, versions in _grouped_listing(
                model_type, language, script, keyword, callback).items()}


def get_listing_versions(model_type: str = 'all', language=None, script=None,
                         keyword=None,
                         callback=lambda total, advance: None) -> dict[str, list]:
    """
    Like :func:`get_listing` but retains EVERY matching version per concept
    DOI, newest first — the shape the CLI's version-tree table renders
    (reference: kraken/kraken.py:780-786 lists all deposits of a concept).
    """
    return _grouped_listing(model_type, language, script, keyword, callback)


def _grouped_listing(model_type, language, script, keyword,
                     callback) -> dict[str, list]:
    mopo = _htrmopo()
    full = mopo.get_listing(callback=callback)

    def _matches(meta: dict[str, Any]) -> bool:
        if not _is_kraken_record(meta):
            return False
        if model_type != 'all' and model_type not in (meta.get('model_type') or ()):
            return False
        if script and not set(script) & set(meta.get('script') or ()):
            return False
        if language and not set(language) & set(meta.get('language') or ()):
            return False
        if keyword and not set(keyword) & set(meta.get('keywords') or ()):
            return False
        return True

    concepts: dict[str, list[dict[str, Any]]] = {}
    for item in full.values():
        if isinstance(item, dict) and ('v0' in item or 'v1' in item):
            # prefer the richer v1 metadata schema for the same deposit
            record = item.get('v1', item.get('v0'))
        else:
            record = item
        if record is None:
            continue
        meta = _meta(record)
        if not _matches(meta):
            continue
        concepts.setdefault(meta.get('concept_doi') or meta.get('doi'), []).append(meta)

    for versions in concepts.values():
        versions.sort(key=lambda m: str(m.get('publication_date') or ''), reverse=True)
    return concepts


def get_model(model_id: str, path: Optional[str] = None,
              callback=lambda total, advance: None) -> str:
    """
    Downloads a model archive, returning the directory it was placed in.
    """
    mopo = _htrmopo()
    return mopo.get_model(model_id, path, callback=callback)


def publish_model(model_card: dict, model_path, access_token: str,
                  private: bool = False, callback=lambda total, advance: None) -> str:
    """
    Publishes a model to the repository, returning the new DOI.
    """
    mopo = _htrmopo()
    return mopo.publish_model(model_path, model_card, access_token,
                              private=private, callback=callback)


def update_model(doi: str, model_card: dict, model_path, access_token: str,
                 private: bool = False, callback=lambda total, advance: None) -> str:
    """
    Updates an existing repository record, returning the new version DOI
    (reference: ketos/repo.py --doi → htrmopo.update_model).
    """
    mopo = _htrmopo()
    return mopo.update_model(model_path, model_card, access_token,
                             model_id=doi, private=private, callback=callback)
