"""Pascal-Parts dataset: object + part masks from VOC ``.mat`` annotations.

The port's own copy of the JAX package's ``data/datasets/pascal_parts.py``
(the reference's ``register_pascal_parts.py``): each ``Annotations_Part``
``.mat`` file (read with ``struct_as_record=False, squeeze_me=True``, so one
object squeezes to a struct, not an array) becomes object and part masks,
and raw part names such as ``lfleg`` / ``rbleg`` / ``leg_1`` are merged into
canonical parts (``leg``) by rule: ``_<n>`` instance suffixes and
left / right / front / back / upper / lower prefixes are stripped.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..catalog import Metadata

__all__ = ["canonical_part_name", "load_pascal_parts", "pascal_parts_metadata"]

# VOC part-name prefixes that encode side/position, not identity.
_POSITION_PREFIXES = (
    "lf", "rf", "lb", "rb",   # left/right front/back (quadruped legs)
    "fl", "fr", "bl", "br",   # wheels/mirrors
    "l", "r",                 # left/right (eye, ear, wing, ...)
)
_POSITION_WORDS = ("front", "back", "left", "right", "upper", "lower")


def canonical_part_name(raw: str) -> str:
    """lfleg -> leg, reye -> eye, wheel_2 -> wheel, fliplate -> liplate."""
    name = re.sub(r"_\d+$", "", raw.strip().lower())
    for word in _POSITION_WORDS:
        if name.startswith(word) and len(name) > len(word):
            return name[len(word):].lstrip("_")
    for prefix in _POSITION_PREFIXES:
        rest = name[len(prefix):]
        # only strip when the remainder is a word of its own (avoid "leg"->"eg")
        if name.startswith(prefix) and len(rest) >= 3 and rest.isalpha():
            return rest
    return name


def _load_mat(path: str):
    import scipy.io as sio

    return sio.loadmat(path, struct_as_record=False, squeeze_me=True)


def load_pascal_parts(
    annotation_dir: str,
    image_dir: str,
    image_set_file: Optional[str] = None,
    object_classes: Optional[Sequence[str]] = None,
    min_part_area: int = 1,
    debug_limit: Optional[int] = None,
) -> List[dict]:
    """Items: {image_id, file_name, objects: [{class_name, mask, parts:
    [{name, mask}]}]} with masks as uint8 numpy arrays (annotations are small
    per-image .mat files; eager decode mirrors register_pascal_parts.py:38-67).
    """
    if image_set_file:
        with open(image_set_file) as f:
            ids = [line.split()[0] for line in f if line.strip()]
    else:
        ids = sorted(
            os.path.splitext(n)[0] for n in os.listdir(annotation_dir)
            if n.endswith(".mat")
        )

    keep_classes = set(object_classes) if object_classes else None
    items: List[dict] = []
    for image_id in ids:
        mat_path = os.path.join(annotation_dir, image_id + ".mat")
        if not os.path.exists(mat_path):
            continue
        anno = _load_mat(mat_path)["anno"]
        objs = np.atleast_1d(anno.objects)
        objects = []
        for obj in objs:
            class_name = str(getattr(obj, "class"))  # 'class' is a mat field name
            if keep_classes and class_name not in keep_classes:
                continue
            parts = []
            for part in np.atleast_1d(getattr(obj, "parts", [])):
                if part is None or not hasattr(part, "part_name"):
                    continue
                mask = np.asarray(part.mask, dtype=bool)
                if mask.sum() < min_part_area:
                    continue
                parts.append({
                    "name": canonical_part_name(str(part.part_name)),
                    "mask": mask,
                })
            objects.append({
                "class_name": class_name,
                "mask": np.asarray(obj.mask, dtype=bool),
                "parts": parts,
            })
        if not objects:
            continue
        items.append({
            "image_id": image_id,
            "file_name": os.path.join(image_dir, image_id + ".jpg"),
            "objects": objects,
        })
        if debug_limit and len(items) >= debug_limit:
            break
    return items


def pascal_parts_metadata(items: List[dict], name: str = "pascal_parts") -> Metadata:
    class_names = sorted({o["class_name"] for it in items for o in it["objects"]})
    part_names = sorted({
        f"{o['class_name']}:{p['name']}"
        for it in items for o in it["objects"] for p in o["parts"]
    })
    return Metadata(name=name, class_names=class_names, part_class_names=part_names)
