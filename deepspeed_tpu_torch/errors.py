"""Config errors shared by every layer of the port (models, ops, the
training runtime and ``initialize``), kept apart from ``runtime/config.py``
so that a layer can raise them without importing config parsing."""

from __future__ import annotations


class DeepSpeedConfigError(Exception):
    pass


class NotPortedError(DeepSpeedConfigError, NotImplementedError):
    """An option of the reference that the PyTorch port does not run yet."""
