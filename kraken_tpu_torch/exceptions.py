"""
Exception hierarchy for kraken_tpu_torch.

Mirrors the error surface of the reference engine
(kraken/lib/exceptions.py) so downstream code can
catch the same categories of failure.
"""

__all__ = ['KrakenError', 'KrakenCodecException', 'KrakenStopTrainingException',
           'KrakenEncodeException', 'KrakenRecordException',
           'KrakenInvalidModelException', 'KrakenInputException',
           'KrakenRepoException', 'KrakenCairoSurfaceException']


class KrakenError(Exception):
    """Base class for all kraken_tpu_torch errors."""

    def __init__(self, message=None):
        super().__init__(message)
        self.message = message


class KrakenCodecException(KrakenError):
    """Raised for invalid codec definitions (non-singular/non-prefix-free)."""


class KrakenStopTrainingException(KrakenError):
    """Raised to terminate a training run early."""


class KrakenEncodeException(KrakenError):
    """Raised when a string cannot be encoded/decoded by a strict codec."""


class KrakenRecordException(KrakenError):
    """Raised for invalid OCR record operations."""


class KrakenInvalidModelException(KrakenError):
    """Raised when a model file cannot be parsed or is structurally invalid."""


class KrakenInputException(KrakenError):
    """Raised for invalid user input (images, specs, configuration)."""


class KrakenRepoException(KrakenError):
    """Raised for model repository access failures."""


class KrakenCairoSurfaceException(KrakenError):
    """Raised for errors in (legacy) surface generation."""

    def __init__(self, message: str, width: int, height: int) -> None:
        super().__init__(message)
        self.width = width
        self.height = height
