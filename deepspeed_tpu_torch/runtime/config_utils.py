"""Typed-config helpers (port of deepspeed_tpu/runtime/config_utils.py) —
analog of reference ``deepspeed/runtime/config_utils.py``.

The JAX package builds its sections on pydantic; the port's machines need
not have it, so :class:`DeepSpeedConfigModel` is a small plain-Python base
with the same observable behaviour for the port's sections: class-level
annotated defaults, keyword construction, field aliases, nested sections
built from dicts, and unknown keys kept as attributes (the reference's
``extra="allow"``).
"""

from __future__ import annotations

import copy
from typing import Any, Dict


class DeepSpeedConfigModel:
    """Base for config sections. Subclasses declare fields as annotated
    class attributes with defaults; ``_aliases`` maps alternative key names
    to fields and ``_nested`` maps a field to the section class a dict value
    is built into."""

    _aliases: Dict[str, str] = {}
    _nested: Dict[str, type] = {}

    def __init__(self, **data):
        for name, default in self._field_defaults().items():
            setattr(self, name, copy.deepcopy(default))
        for key, value in data.items():
            name = self._aliases.get(key, key)
            cls = self._nested.get(name)
            if cls is not None and isinstance(value, dict):
                value = cls(**value)
            setattr(self, name, value)

    @classmethod
    def _field_defaults(cls) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for klass in reversed(cls.__mro__):
            for name in getattr(klass, "__annotations__", {}):
                if not name.startswith("_"):
                    out[name] = getattr(cls, name, None)
        return out

    def dict_repr(self) -> Dict[str, Any]:
        return {k: (v.dict_repr() if isinstance(v, DeepSpeedConfigModel) else v)
                for k, v in vars(self).items()}

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.dict_repr()})"


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """json.load object_pairs_hook that rejects duplicate keys
    (reference config_utils.dict_raise_error_on_duplicate_keys)."""
    d = dict(ordered_pairs)
    if len(d) != len(ordered_pairs):
        counter = {}
        for k, _ in ordered_pairs:
            counter[k] = counter.get(k, 0) + 1
        keys = [k for k, v in counter.items() if v > 1]
        raise ValueError(f"Duplicate keys in DeepSpeed config: {keys}")
    return d
