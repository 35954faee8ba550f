"""
Logging setup with rich console output (reference: kraken/lib/log.py).
"""
import logging

__all__ = ['set_logger']


def set_logger(logger=None, level: int = logging.ERROR) -> None:
    """Attaches a rich handler (plain StreamHandler fallback) to `logger`."""
    if logger is None:
        logger = logging.getLogger()
    try:
        from rich.logging import RichHandler
        handler = RichHandler(rich_tracebacks=True)
    except ImportError:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter('%(levelname)s %(name)s: %(message)s'))
    logger.addHandler(handler)
    logger.setLevel(level)
