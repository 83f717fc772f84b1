"""One file per task, named as a configuration's ``task``
(``supervised`` -> ``tasks/supervised.py``). Each provides:

- ``FIELDS``: the target fields a batch carries besides its image, under
  the wire format's names; the checked steps keep them for the reference;
- ``loss_fn(cfg, seg, model, device)``: the program's loss of the train
  step, from the task's model config over the program's segmenter config
  ``seg`` and its ``make_loss_fn``;
- ``targets(fields) -> dict``: the reference's ``masks``, ``valid`` and
  ``labels`` of a step from a batch's ``FIELDS`` as tensors;
- ``reference_loss(out, tgt, noise, crit, indices=None, per_image=False)``:
  the reference's matching (unless ``indices`` fixes the matched queries)
  and criterion of one step: ``(total, per-layer [ce, mask, dice])``, with
  ``per_image`` also each image's share of the total.
"""

from __future__ import annotations

import importlib


def load(cfg: dict):
    """The module of a configuration's task."""
    return importlib.import_module(f".{cfg['task']}", __name__)
