"""One file per backbone, named as the configuration's backbone group: the
key of its ``model`` group that is neither ``pixel_decoder`` nor
``decoder`` (``swin`` -> ``backbones/swin.py``). Each provides, from that
group:

- ``program_config(group, dtype) -> dict``: the backbone's field of the
  program's ``SegmenterConfig``, as keyword arguments;
- ``reference(rnd, group) -> (module, channels)``: the plain float32
  backbone (``forward(x, drop_keep)`` -> ``{"res2": ..., "res5": ...}``,
  channel-last) and the channels of each level, its parameters under the
  program's names;
- ``level_shapes(size, group)``: the (h, w) of res5, res4 and res3 at a
  square input, and ``stage_sizes(size, group)``: the token grid's side at
  each stage;
- ``draw_noise(group, batch, uniform) -> dict``: the step's backbone noise,
  drawn first in a step through ``uniform(*shape)`` (``drop_keep``, if any: the
  DropPath keep decisions the reference's forward takes);
- ``weight_rule(name, p, kind)``: ``(fill, std, truncate)`` of a leaf of its
  own that the general rules of ``weights.py`` do not cover, else None;
- ``NO_DECAY``: substrings of the names of its leaves that the reference's
  AdamW does not decay (the program's optimizer's own list);
- ``TINY``: the group's widths in the CPU tests' tiny configurations.
"""

from __future__ import annotations

import importlib

OTHER_GROUPS = ("pixel_decoder", "decoder")


def load(model_cfg: dict):
    """(the backbone's module, its group) of a configuration's ``model``
    group."""
    (name,) = [k for k in model_cfg if k not in OTHER_GROUPS]
    return importlib.import_module(f".{name}", __name__), model_cfg[name]
