"""ImageNet-style dataset registrars (the stage-3 and stage-5 inputs).

The port's own copy of the JAX package's ``data/datasets/imagenet.py`` for
stage 3: the class-directory walk (labels from labels.txt or
synsets.dat + words.txt, class filtering, exclusion, single class,
contiguous class partitions), the cached ``{class_code: [file, ...]}``
manifest, resume skips, the join with a stage-2 proposal store
(``load_imagenet_with_proposals``) and the join with a stage-4 store of
class-labeled part masks (``load_imagenet_with_segmentation``). Both packages
list the same items in the same order.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Set

from ..catalog import Metadata
from ..pseudo_store import PseudoLabelStore

__all__ = [
    "read_class_names",
    "global_code_to_id",
    "build_manifest",
    "load_imagenet",
    "load_imagenet_with_proposals",
    "load_imagenet_with_segmentation",
    "imagenet_metadata",
]

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".JPEG", ".JPG", ".PNG")


def build_manifest(root: str, path: str) -> Dict[str, List[str]]:
    """One-time directory walk cached as JSON: {class_code: [file, ...]}.

    At IN-22K scale (~22k class dirs, 14M files) the per-startup listdir walk
    the reference does (register_imagenet.py:33-41, SURVEY §7 hard-part #7)
    costs minutes on network filesystems and multiplies by every job in the
    farm; the manifest makes startup one file read. Built atomically
    (tmp + rename) so concurrent hosts racing to create it are safe — they
    each write identical content.
    """
    import json
    import tempfile

    manifest: Dict[str, List[str]] = {}
    for code in sorted(os.listdir(root)):
        class_dir = os.path.join(root, code)
        if code.startswith(".") or not os.path.isdir(class_dir):
            continue
        manifest[code] = sorted(
            f for f in os.listdir(class_dir) if f.endswith(_IMG_EXTS))
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".manifest.tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, path)
    return manifest


def _load_manifest(root: str, path: Optional[str]) -> Optional[Dict[str, List[str]]]:
    """Read (or build-and-cache) the manifest; None when disabled."""
    if not path:
        return None
    import json

    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return build_manifest(root, path)


def read_class_names(root: str) -> Dict[str, str]:
    """code -> human name. Supports labels.txt ("code name...") or
    synsets.dat + words.txt (code<TAB>name), as in register_imagenet.py:83-98."""
    names: Dict[str, str] = {}
    labels = os.path.join(root, "labels.txt")
    words = os.path.join(root, "words.txt")
    if os.path.exists(labels):
        with open(labels) as f:
            for line in f:
                parts = line.strip().split(None, 1)
                if len(parts) == 2:
                    names[parts[0]] = parts[1].split(",")[0].strip()
    elif os.path.exists(words):
        with open(words) as f:
            for line in f:
                parts = line.strip().split("\t", 1)
                if len(parts) == 2:
                    names[parts[0]] = parts[1].split(",")[0].strip()
    return names


def global_code_to_id(root: str,
                      vocab_map: Optional[str] = None,
                      manifest: Optional[str] = None) -> Dict[str, int]:
    """The dataset-global synset-code -> class-id mapping: ids assigned over
    the sorted full class-directory list, identical on every host/shard. This
    is the vocabulary stages 4/5 key their centroid banks and part-classifier
    head by — eval datasets must map their codes through it.

    ``vocab_map``: optional path to a JSON ``{code: id}`` file that REPLACES
    the derived mapping — the supplied-vocabulary contract for aligning runs
    across dataset variants (e.g. scoring a 22k-trained head on a 1k split),
    the analog of the reference's imagenet1k_to_22k_mapping.pkl
    (part_imagenet_mapper.py:100-103)."""
    if vocab_map:
        import json

        with open(vocab_map) as f:
            loaded = json.load(f)
        return {str(c): int(i) for c, i in loaded.items()}
    m = _load_manifest(root, manifest)
    if m is not None:
        codes = sorted(m)
    else:
        codes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)) and not d.startswith(".")
        )
    return {c: i for i, c in enumerate(codes)}


def _partition(seq: Sequence, index: Optional[int], total: Optional[int]) -> List:
    """Slice a class list into `total` contiguous chunks; chunk `index`.

    Matches the reference's per-job class slicing (register_imagenet.py:125-131).
    """
    seq = list(seq)
    if not total or total <= 1:
        return seq
    n = len(seq)
    per = (n + total - 1) // total
    return seq[index * per : (index + 1) * per]


def load_imagenet(
    root: str,
    class_list: Optional[Sequence[str]] = None,
    exclude_codes: Optional[Sequence[str]] = None,
    single_class_code: Optional[str] = None,
    partition_index: Optional[int] = None,
    total_partitions: Optional[int] = None,
    skip_ids: Optional[Set[str]] = None,
    object_mask_store: Optional[str] = None,
    debug_limit: Optional[int] = None,
    vocab_map: Optional[str] = None,
    manifest: Optional[str] = None,
) -> List[dict]:
    """Items: {image_id, file_name, class_code, class_id, class_name[, object_record]}.

    * ``skip_ids``: image ids already present in the stage's output store —
      the resume contract (register_imagenet.py:42).
    * ``object_mask_store``: a stage-1 store dir; when given, only images with
      a saved object record are kept and the record is attached lazily as
      ``object_store``+``image_id`` (the WITH_GIVEN_MASK path,
      register_imagenet.py:49-55).
    """
    names = read_class_names(root)
    # cached manifest (one-time walk) replaces the O(classes) listdir storm
    # at every startup; None = walk the directories directly
    mfst = _load_manifest(root, manifest)
    # class ids are GLOBAL — assigned over the UNFILTERED sorted listing
    # (exactly global_code_to_id), never over a filtered subset: every
    # shard/host/filter combination must agree on code <-> id, because
    # stages 4/5 key centroid banks and the part-classifier head by class_id
    # across the whole dataset. Filters only narrow which classes are
    # *enumerated*.
    code_to_id = global_code_to_id(root, vocab_map, manifest)
    # with a supplied vocabulary, only classes that exist on disk enumerate
    if mfst is not None:
        codes = sorted(c for c in code_to_id if c in mfst)
    else:
        codes = sorted(c for c in code_to_id
                       if os.path.isdir(os.path.join(root, c)))
    if single_class_code:
        codes = [c for c in codes if c == single_class_code]
    if class_list is not None:
        keep = set(class_list)
        codes = [c for c in codes if c in keep]
    if exclude_codes:
        drop = set(exclude_codes)
        codes = [c for c in codes if c not in drop]
    codes = _partition(codes, partition_index, total_partitions)

    store = PseudoLabelStore(object_mask_store) if object_mask_store else None
    skip_ids = skip_ids or set()

    items: List[dict] = []
    for code in codes:
        class_dir = os.path.join(root, code)
        if mfst is not None:
            fnames = mfst[code]
        else:
            fnames = sorted(f for f in os.listdir(class_dir)
                            if f.endswith(_IMG_EXTS))
        for fname in fnames:
            image_id = os.path.splitext(fname)[0]
            if image_id in skip_ids:
                continue
            if store is not None and image_id not in store:
                continue
            item = {
                "image_id": image_id,
                "file_name": os.path.join(class_dir, fname),
                "class_code": code,
                "class_id": code_to_id[code],
                "class_name": names.get(code, code),
            }
            if store is not None:
                item["object_store"] = object_mask_store
            items.append(item)
            if debug_limit and len(items) >= debug_limit:
                return items
    return items


def imagenet_metadata(root: str, items: List[dict], name: str = "imagenet") -> Metadata:
    codes = sorted({it["class_code"] for it in items})
    names = read_class_names(root)
    return Metadata(
        name=name,
        class_codes=codes,
        class_code_to_class_id={c: i for i, c in enumerate(codes)},
        class_names=[names.get(c, c) for c in codes],
    )


def load_imagenet_with_proposals(
    imagenet_items: List[dict],
    proposal_store_dir: str,
    min_object_area_ratio: float = 0.0,
    path_only: bool = True,
    debug_limit: Optional[int] = None,
) -> List[dict]:
    """Join images with stage-2 (dCRF-smoothed) part-proposal records.

    ``object_ratio`` filtering per register_imagenet_with_proposals.py:58;
    ``path_only`` keeps the join lazy (mapper loads the record), mirroring
    the reference's path-tuple datasets (:31-78) that avoid loading millions
    of annotation payloads at register time.
    """
    store = PseudoLabelStore(proposal_store_dir)
    # payload-free membership unless the filter (or eager load) needs the
    # record — at IN-22K scale a full get() per image unpickles every mask
    need_record = (min_object_area_ratio > 0.0) or not path_only
    out: List[dict] = []
    for item in imagenet_items:
        record = None
        if need_record:
            record = store.get(item["image_id"])
            if record is None:
                continue
            if record.get("object_ratio", 1.0) <= min_object_area_ratio:
                continue
        elif item["image_id"] not in store:
            continue
        joined = dict(item)
        if path_only:
            joined["proposal_store"] = proposal_store_dir
        else:
            joined["proposals"] = record
        out.append(joined)
        if debug_limit and len(out) >= debug_limit:
            break
    return out


def load_imagenet_with_segmentation(imagenet_items: List[dict],
                                    part_label_store_dir: str) -> List[dict]:
    """Join images with stage-4 class-labeled part masks
    (register_imagenet_with_segmentation.py:31-53): lazily, by the store's
    index; the mapper reads the record."""
    store = PseudoLabelStore(part_label_store_dir)
    out: List[dict] = []
    for item in imagenet_items:
        if item["image_id"] not in store:  # index-only membership
            continue
        joined = dict(item)
        joined["part_label_store"] = part_label_store_dir
        out.append(joined)
    return out
