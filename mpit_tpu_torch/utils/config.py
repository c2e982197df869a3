"""Typed configuration system.

The reference uses two styles: ad-hoc Lua ``opt`` tables with ``opt.x or
default`` fallbacks (reference asyncsgd/mlaunch.lua:33-47, goot.lua:4-17) and
a ~50-flag torch.CmdLine surface (reference BiCNN/plaunch.lua:7-69).  Here
there is one system from day one: a dataclass-like ``Config`` that is

- attribute- and item-accessible with defaults (``cfg.get("lr", 1e-2)``),
- convertible to/from flat CLI args (``--lr 1e-2 --opt easgd``),
- mergeable (launcher defaults < experiment overrides < CLI).

A copy of :mod:`mpit_tpu.utils.config`: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Iterator, Mapping, Optional


class Config:
    """A mapping with attribute access and typed CLI parsing."""

    def __init__(self, **kwargs: Any) -> None:
        self.__dict__["_data"] = dict(kwargs)

    # -- mapping protocol ---------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        try:
            return self.__dict__["_data"][key]
        except KeyError:
            raise AttributeError(key) from None

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = value

    # -- composition --------------------------------------------------------
    def merged(self, other: Optional[Mapping[str, Any]] = None, **kwargs: Any) -> "Config":
        """New Config = self overridden by ``other`` then ``kwargs``."""
        data: Dict[str, Any] = dict(self._data)
        if other:
            data.update(other)
        data.update(kwargs)
        return Config(**data)

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._data)

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={v!r}" for k, v in sorted(self._data.items()))
        return f"Config({body})"

    # -- CLI ----------------------------------------------------------------
    def parse_args(self, argv: Optional[list[str]] = None) -> "Config":
        """Parse ``--key value`` flags typed from this config's defaults.

        Bools accept true/false; unknown flags are an error.  Returns a new
        merged Config (the analog of torch.CmdLine:parse, reference
        BiCNN/plaunch.lua:70).
        """
        parser = argparse.ArgumentParser()
        exposed = []
        for key, default in self._data.items():
            flag = "--" + key
            if isinstance(default, bool):
                parser.add_argument(flag, type=_parse_bool, default=default)
            elif default is None:
                parser.add_argument(flag, type=str, default=None)
            elif isinstance(default, (int, float, str)):
                parser.add_argument(flag, type=type(default), default=default)
            else:
                continue  # non-scalar defaults are not CLI-settable
            exposed.append(key)
        ns = parser.parse_args(argv)
        return self.merged({k: getattr(ns, k) for k in exposed})


def _parse_bool(text: str) -> bool:
    lowered = text.lower()
    if lowered in ("1", "true", "yes", "on"):
        return True
    if lowered in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"not a bool: {text!r}")
