"""Config system: typed dataclass tree + YAML overlay + dotted CLI overrides.

The port's own copy of the JAX package's ``config.py``, reading the same
``configs/**/*.yaml`` in place:

* configs are frozen dataclasses, so typos fail at construction;
* ``_BASE_`` inheritance is kept (a yaml may name a base yaml, merged
  depth-first, child wins);
* CLI ``key.path=value`` overrides win last, as detectron2's ``opts`` do.

PyYAML is imported only where a yaml is read.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Tuple, Type, TypeVar, get_args, get_origin

T = TypeVar("T")

__all__ = ["dataclass_from_dict", "apply_overrides", "load_yaml_tree",
           "load_config", "config_to_dict", "PipelineConfig", "DataConfig",
           "StagePaths"]


# ---------------------------------------------------------------- generic


def _convert(value: Any, typ: Any) -> Any:
    origin = get_origin(typ)
    if value is None:
        return None
    if dataclasses.is_dataclass(typ) and isinstance(value, dict):
        return dataclass_from_dict(typ, value)
    if origin in (tuple, Tuple) and isinstance(value, (list, tuple)):
        args = get_args(typ)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_convert(v, args[0]) for v in value)
        if args:
            return tuple(_convert(v, a) for v, a in zip(value, args))
        return tuple(value)
    if origin in (list, List) and isinstance(value, (list, tuple)):
        args = get_args(typ)
        return [_convert(v, args[0]) if args else v for v in value]
    if origin is not None and str(origin).endswith("Union"):  # Optional[...]
        for arg in get_args(typ):
            if arg is type(None):
                continue
            try:
                return _convert(value, arg)
            except (TypeError, ValueError):
                continue
        return value
    if typ is float and isinstance(value, (int, float)):
        return float(value)
    if typ is int and isinstance(value, int):
        return int(value)
    if typ is bool and isinstance(value, bool):
        return value
    return value


def dataclass_from_dict(cls: Type[T], data: Dict[str, Any]) -> T:
    """Recursively build dataclass `cls`, erroring on unknown keys."""
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls} is not a dataclass")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise KeyError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for name, value in data.items():
        f = fields[name]
        typ = f.type
        if isinstance(typ, str):  # from __future__ annotations
            import typing

            typ = eval(typ, vars(typing), _type_namespace(cls))  # noqa: S307
        kwargs[name] = _convert(value, typ)
    return cls(**kwargs)


def _type_namespace(cls) -> dict:
    import sys

    module = sys.modules.get(cls.__module__)
    return vars(module) if module else {}


def _merge_dicts(base: dict, overlay: dict) -> dict:
    out = dict(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge_dicts(out[k], v)
        else:
            out[k] = v
    return out


def load_yaml_tree(path: str) -> dict:
    """YAML file -> dict, following ``_BASE_`` inheritance (child wins)."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    base_name = data.pop("_BASE_", None)
    if base_name:
        base_path = os.path.join(os.path.dirname(path), base_name)
        return _merge_dicts(load_yaml_tree(base_path), data)
    return data


def _parse_scalar(text: str) -> Any:
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none"):
        return None
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    if text.startswith("[") or text.startswith("("):
        import yaml

        return yaml.safe_load(text.replace("(", "[").replace(")", "]"))
    return text


def apply_overrides(tree: dict, overrides: List[str]) -> dict:
    """['a.b.c=1', ...] applied onto a nested dict (wins last)."""
    out = dict(tree)
    for entry in overrides or []:
        if "=" not in entry:
            raise ValueError(f"override {entry!r} must be key.path=value")
        key, _, raw = entry.partition("=")
        parts = key.strip().split(".")
        node = out
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                nxt = {}
            node[p] = dict(nxt)
            node = node[p]
        node[parts[-1]] = _parse_scalar(raw.strip())
    return out


def config_to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


# ---------------------------------------------------------------- pipeline


@dataclasses.dataclass(frozen=True)
class StagePaths:
    """Filesystem layout of the pipeline's pseudo-label stores — the explicit
    version of the reference's save-path string templates
    (proposal_generation_net.py:93-99, SURVEY.md §1 dataflow)."""

    root: str = "pseudo_labels"

    @property
    def object_labels(self) -> str:          # stage-1 output
        return os.path.join(self.root, "object_labels")

    @property
    def proposals(self) -> str:              # stage-2 output (raw)
        return os.path.join(self.root, "proposal_generation")

    @property
    def proposals_dcrf(self) -> str:         # stage-2b output (smoothed)
        return os.path.join(self.root, "proposals_dcrf")

    @property
    def part_masks_with_class(self) -> str:  # stage-4 output
        return os.path.join(self.root, "part_masks_with_class")

    @property
    def predictions(self) -> str:            # stage-5 save output
        return os.path.join(self.root, "part_distillation_predictions")


@dataclasses.dataclass(frozen=True)
class DataConfig:
    imagenet_root: str = "datasets/imagenet_22k"
    part_imagenet_json: str = ""
    part_imagenet_images: str = ""
    pascal_parts_annotations: str = ""
    pascal_parts_images: str = ""
    cityscapes_part_labels: str = ""
    cityscapes_images: str = ""
    image_size: int = 640
    mask_capacity: int = 8
    batch_size: int = 8
    num_workers: int = 8
    partition_index: Optional[int] = None
    total_partitions: Optional[int] = None
    debug_limit: Optional[int] = None
    # optional JSON {synset_code: class_id} overriding the directory-derived
    # vocabulary — aligns runs across dataset variants (the reference's
    # imagenet1k_to_22k_mapping.pkl, part_imagenet_mapper.py:100-103)
    vocab_map: str = ""
    # optional cached {class_code: [file, ...]} manifest JSON: startup becomes
    # one file read instead of an O(classes) listdir walk (built on first use;
    # SURVEY §7 hard-part #7, register_imagenet.py:33-41)
    manifest: str = ""


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level config: data paths + every stage's model/run config."""

    data: DataConfig = DataConfig()
    paths: StagePaths = StagePaths()
    seed: int = 0
    checkpoint_dir: str = "checkpoints"
    max_iters: int = 1000
    log_every: int = 20
    checkpoint_every: int = 1000
    # run the stage's evaluator on the held-out GT set every N steps during
    # training (the reference's TEST.EVAL_PERIOD, train_multi.sh:61); 0 = off
    eval_every: int = 0
    # save prediction-vs-GT overlay collages of the live train batch every N
    # steps (the reference's VIS_PERIOD, proposal_model.py:198-211); 0 = off
    vis_every: int = 0
    n_model_shards: int = 1


def load_config(cls: Type[T], yaml_path: Optional[str] = None,
                overrides: Optional[List[str]] = None) -> T:
    tree: dict = {}
    if yaml_path:
        tree = load_yaml_tree(yaml_path)
    tree = apply_overrides(tree, overrides or [])
    return dataclass_from_dict(cls, tree)
