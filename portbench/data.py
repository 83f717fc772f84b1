"""The traffic generator: a seeded synthetic image set written where the
program's data layer reads it.

One function for every traffic file. Its parameters (``traffic/<name>.json``)
are the number of images, the short side and aspect ranges, the objects an
image and how each is cut into parts, and the store kind. The images are
ImageNet-like JPEGs in synset folders; the store kind's module
(``stores/<store>.py``) writes its files over them: ``proposals`` a stage-2b
part proposal store, ``part_imagenet`` a PartImageNet-style COCO json whose
parts are polygons with part classes.

Images: a smooth random colour field with mild noise and each object an
ellipse of its own colour. Parts: each object is cut into pieces around
random seed points inside it (k-means-like cells: every pixel of the object
goes to its nearest seed). Everything follows from ``seed`` through one
``numpy.random.Generator``; the same seed gives the same files.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np

from . import stores

CODES = ("n01440764", "n01443537", "n01484850", "n01491361")


def _image_plan(rng: np.random.Generator, t: dict) -> List[dict]:
    """Per image: size, colours, objects (ellipse, part seeds, part classes)."""
    plans = []
    lo, hi = t["short_side"]
    alo, ahi = t["aspect"]
    for i in range(t["images"]):
        short = int(rng.integers(lo, hi + 1))
        aspect = float(np.exp(rng.uniform(np.log(alo), np.log(ahi))))
        h, w = (short, int(round(short * aspect))) if aspect >= 1 else \
            (int(round(short / aspect)), short)
        objs = []
        for _ in range(int(rng.integers(t["objects"][0], t["objects"][1] + 1))):
            cy, cx = rng.uniform(0.25, 0.75) * h, rng.uniform(0.25, 0.75) * w
            ry, rx = rng.uniform(0.15, 0.35) * h, rng.uniform(0.15, 0.35) * w
            n_parts = int(rng.integers(t["parts"][0], t["parts"][1] + 1))
            ang = rng.uniform(0, 2 * np.pi, n_parts)
            rad = rng.uniform(0.2, 0.8, n_parts)
            seeds = np.stack([cy + ry * rad * np.sin(ang), cx + rx * rad * np.cos(ang)], -1)
            objs.append({"centre": (cy, cx), "radii": (ry, rx), "seeds": seeds,
                         "colour": rng.integers(0, 256, 3),
                         "classes": rng.integers(0, t.get("part_classes", 1), n_parts)})
        plans.append({"index": i, "size": (h, w), "field": rng.integers(0, 256, (4, 4, 3)),
                      "noise_seed": int(rng.integers(0, 2**31)), "objects": objs})
    return plans


def _render(plan: dict) -> Tuple[np.ndarray, List[Tuple[np.ndarray, int]]]:
    """(uint8 image, [(part mask, part class)])."""
    from PIL import Image

    h, w = plan["size"]
    field = Image.fromarray(plan["field"].astype(np.uint8)).resize((w, h), Image.BILINEAR)
    img = np.asarray(field, np.int16).copy()
    img += np.random.default_rng(plan["noise_seed"]).integers(-12, 13, (h, w, 3),
                                                              dtype=np.int16)
    parts = []
    taken = np.zeros((h, w), bool)
    for obj in plan["objects"]:
        (cy, cx), (ry, rx) = obj["centre"], obj["radii"]
        y0, y1 = max(int(cy - ry), 0), min(int(cy + ry) + 2, h)
        x0, x1 = max(int(cx - rx), 0), min(int(cx + rx) + 2, w)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        inside &= ~taken[y0:y1, x0:x1]
        taken[y0:y1, x0:x1] |= inside
        img[y0:y1, x0:x1][inside] = obj["colour"]
        d = (yy[..., None] - obj["seeds"][:, 0]) ** 2 + (xx[..., None] - obj["seeds"][:, 1]) ** 2
        cell = d.argmin(-1)
        for k, cls in enumerate(obj["classes"]):
            m = np.zeros((h, w), bool)
            m[y0:y1, x0:x1] = inside & (cell == k)
            if m.sum() >= 16:
                parts.append((m, int(cls)))
    return np.clip(img, 0, 255).astype(np.uint8), parts


def write_dataset(root: str, traffic: dict, seed: int, threads: int = 8) -> Dict[str, str]:
    """Write the traffic's image set under ``root``; returns its paths:
    ``imagenet_root`` and the store's (``proposals`` or ``part_json``)."""
    rng = np.random.default_rng(seed)
    plans = _image_plan(rng, traffic)
    image_root = os.path.join(root, "imagenet")
    for code in CODES:
        os.makedirs(os.path.join(image_root, code), exist_ok=True)

    def one(plan):
        from PIL import Image

        img, parts = _render(plan)
        code = CODES[plan["index"] % len(CODES)]
        name = f"{code}_{plan['index']}"
        Image.fromarray(img).save(os.path.join(image_root, code, name + ".JPEG"), quality=90)
        return code, name, img.shape[:2], parts

    with ThreadPoolExecutor(threads) as pool:
        made = list(pool.map(one, plans))
    return {"imagenet_root": image_root, **stores.load(traffic).write(root, made, traffic)}
