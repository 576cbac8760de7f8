"""Columnar Page data model over torch tensors (counterpart of ``trino_tpu/page.py``).

A page is a fixed-capacity struct of columns: ``columns[i]`` is a 1-D tensor of
``capacity`` elements (dtype from ``types.torch_dtype``), ``null_masks[i]`` an
optional bool tensor (True = NULL) and ``valid`` an optional bool row mask
(None = every lane is live).  Filters narrow ``valid`` instead of moving rows;
compaction at pipeline boundaries (``ops/arrays.compact_rows``) packs the live
lanes when that pays.  VARCHAR columns hold int32 dictionary ids; the
dictionary is host-side metadata owned by the connector.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .types import Type

__all__ = ["Field", "Schema", "Page"]


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    type: Type


@dataclasses.dataclass(frozen=True)
class Schema:
    """Static (hashable) description of a page's columns."""

    fields: tuple[Field, ...]

    def __post_init__(self):
        object.__setattr__(self, "_index", {f.name: i for i, f in enumerate(self.fields)})

    @staticmethod
    def of(*pairs) -> "Schema":
        return Schema(tuple(Field(n, t) for n, t in pairs))

    def index(self, name: str) -> int:
        return self._index[name]

    def field(self, name: str) -> Field:
        return self.fields[self.index(name)]

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(f.name for f in self.fields)

    def __len__(self) -> int:
        return len(self.fields)


@dataclasses.dataclass
class Page:
    """A fixed-capacity columnar batch of rows on one device."""

    schema: Schema
    columns: tuple
    null_masks: tuple
    valid: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return int(self.columns[0].shape[0]) if self.columns else 0

    def column(self, name: str):
        return self.columns[self.schema.index(name)]

    @property
    def device(self) -> torch.device:
        if self.columns:
            return self.columns[0].device
        return self.valid.device if self.valid is not None else torch.device("cpu")

    def valid_mask(self) -> torch.Tensor:
        if self.valid is None:
            return torch.ones((self.capacity,), dtype=torch.bool, device=self.device)
        return self.valid

    def to_numpy(self, dictionaries: Optional[dict] = None) -> dict:
        """Live rows as host numpy arrays, decoding dictionary ids, decimal
        scaling and dates like ``trino_tpu.page.Page.to_numpy``."""
        from .types import CharType, DecimalType, VarcharType

        valid = self.valid_mask().cpu().numpy()
        out = {}
        for f, col, nulls in zip(self.schema.fields, self.columns, self.null_masks):
            arr = col.cpu().numpy()[valid]
            if isinstance(f.type, DecimalType):
                arr = arr.astype(np.float64) / (10**f.type.scale)
            elif isinstance(f.type, (VarcharType, CharType)) and dictionaries \
                    and f.name in dictionaries:
                d = dictionaries[f.name]
                arr = d.decode(arr) if hasattr(d, "decode") else np.asarray(d)[arr]
            elif f.type.name == "date":
                arr = arr.astype("datetime64[D]")
            if nulls is not None:
                n = nulls.cpu().numpy()[valid]
                arr = np.where(n, None, arr) if arr.dtype == object \
                    else np.ma.masked_array(arr, n)
            out[f.name] = arr
        return out
