"""One file per store kind, named as a traffic's ``store``
(``part_imagenet`` -> ``stores/part_imagenet.py``). Each provides:

- ``write(root, images, traffic) -> dict``: the store's files under
  ``root`` for the written images (each ``(synset, name, (h, w), [(part
  mask, part class)])``, as ``data.write_dataset`` made them), and their
  paths;
- ``program_items(paths, size, capacity, seed) -> (items, mapper)``: the
  program's item list over those files and its train mapper, as the
  program's train command builds them;
- ``REFERENCE``: the plain mapper of the store's published format
  (``reference/data.py``: ``REFERENCE(paths, size, capacity).batch(ids)``),
  or None, where the reference trains on the rows the program's loader made.
"""

from __future__ import annotations

import importlib


def load(traffic: dict):
    """The module of a traffic's store kind."""
    return importlib.import_module(f".{traffic['store']}", __name__)
