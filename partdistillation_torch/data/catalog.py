"""Dataset catalog: explicit registry of named datasets + metadata.

The port's own copy of the JAX package's ``data/catalog.py``, in place of
detectron2's global ``DatasetCatalog``/``MetadataCatalog``: registration
returns a ``DatasetSpec`` handle that stage programs pass explicitly, and
modes are explicit on the stage configs, never parsed from dataset names.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Metadata", "DatasetSpec", "DatasetCatalog"]


@dataclasses.dataclass
class Metadata:
    """Free-form metadata bag (class names, id mappings, save paths)."""

    name: str = ""
    class_names: Optional[List[str]] = None
    class_codes: Optional[List[str]] = None  # e.g. ImageNet synset codes
    class_code_to_class_id: Optional[Dict[str, int]] = None
    part_class_names: Optional[List[str]] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DatasetSpec:
    name: str
    loader: Callable[[], List[dict]]  # returns list of item dicts
    metadata: Metadata

    _items: Optional[List[dict]] = None

    def items(self) -> List[dict]:
        if self._items is None:
            self._items = self.loader()
        return self._items

    def __len__(self) -> int:
        return len(self.items())


class DatasetCatalog:
    """Process-local registry; instantiate one per program."""

    def __init__(self):
        self._specs: Dict[str, DatasetSpec] = {}

    def register(self, name: str, loader: Callable[[], List[dict]],
                 metadata: Optional[Metadata] = None) -> DatasetSpec:
        if name in self._specs:
            raise ValueError(f"dataset {name!r} already registered")
        spec = DatasetSpec(name, loader, metadata or Metadata(name=name))
        self._specs[name] = spec
        return spec

    def get(self, name: str) -> DatasetSpec:
        if name not in self._specs:
            raise KeyError(
                f"dataset {name!r} not registered; have {sorted(self._specs)}"
            )
        return self._specs[name]

    def __contains__(self, name: str) -> bool:
        return name in self._specs

    def names(self) -> List[str]:
        return sorted(self._specs)
