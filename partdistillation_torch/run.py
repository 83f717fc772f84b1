"""Stage CLI of the port: stage 1, object labelling (from precomputed
detections, or from pixels with CLIP) and its AR evaluation; stage 2, pixel
grouping and its AR evaluation; stage 2b, dense-CRF smoothing; stage 3,
proposal learning and its AR evaluation; stage 4, part ranking; stage 5,
part distillation, its save pass and its mIoU evaluation; the supervised
/ fewshot ablation, trained and evaluated on a GT part set; and the tools
around them: an environment health check, a profiled train step and a
collage of a store's masks.

  python -m partdistillation_torch.run label               [--device cuda] ...
  python -m partdistillation_torch.run detect              [--device cuda] ...
  python -m partdistillation_torch.run eval-detect         [--device cuda] ...
  python -m partdistillation_torch.run propose             [--device cuda] ...
  python -m partdistillation_torch.run eval-pixel-grouping [--device cuda] ...
  python -m partdistillation_torch.run dcrf                [--device cuda] ...
  python -m partdistillation_torch.run train-proposal      [--device cuda] ...
  python -m partdistillation_torch.run eval-proposal       [--device cuda] ...
  python -m partdistillation_torch.run rank                [--device cuda] ...
  python -m partdistillation_torch.run train-distillation  [--device cuda] ...
  python -m partdistillation_torch.run distill-save        [--device cuda] ...
  python -m partdistillation_torch.run distill-eval        [--device cuda] ...
  python -m partdistillation_torch.run train-supervised    [--device cuda] ...
  python -m partdistillation_torch.run eval-supervised     [--device cuda] ...
  python -m partdistillation_torch.run doctor              [--device cuda] ...
  python -m partdistillation_torch.run profile             [--device cuda] ...
  python -m partdistillation_torch.run visualize           ...

The JAX package's ``run.py`` subcommands of the same names, with their
flags, config (``--config`` yaml, ``--set key.path=value``), data layer,
wire format (uint8 images and bit-packed masks, unpacked on the device;
masks made on the device packed there), resume from the newest checkpoint
or the store's written ids, AR and mIoU evaluation, and store formats (the
stage-2, stage-4 and stage-5 stores, ``rank_centroids.npz``,
``rank_mapping.npz`` and ``distill_mapping.npz`` are read by either
package). The evaluation commands take ``--eval-dataset part_imagenet |
pascal | cityscapes``. They run on ``cuda`` unless ``--device cpu`` is
given, and never fall back to the CPU. The train commands save a collage
of the live batch's predicted masks beside its targets every ``vis_every``
steps (``<checkpoint_dir>/logs/<stage>/vis/step_*.png``).

Multi-GPU runs start one process per GPU with ``torchrun`` (``torchrun
--nproc-per-node N -m partdistillation_torch.run <stage> ...``): every
subcommand joins the process group (NCCL on ``cuda``, gloo on ``cpu``;
``engine/launch.py``) and leaves it at exit, and its ranks form a (data,
model) mesh (``parallel/mesh.py``). ``data.batch_size`` is one rank's batch,
so the global batch is batch_size x n_data, where the JAX CLI fits
gcd(devices / n_model, batch_size) data devices to one host's batch. Each
data rank reads its own class partition of ImageNet (``--shard`` /
``--num-shards`` override it) and its strided share of an evaluation set,
writes its own store shard, and the train steps average their gradients
over the data ranks with the criterion's normalisers taken over all of them
(the JAX package's global-batch step). The evaluators gather over the data
ranks; rank 0 writes checkpoints, ``rank_centroids.npz`` and the mapping
files, and the others wait for them. In the stage-5 commands
``n_model_shards`` splits the part head along its hidden dimension over a
model group of that many ranks, which read the same items; a world it does
not divide raises.

Differences from the JAX CLI:

- ``--params`` names an Orbax tree, which cannot be read without JAX: it
  raises, and ``--torch-params`` (a ``state_dict`` with the port's
  detectron2 keys, loaded by ``load_state_dict``) takes its place;
  ``--trainer-checkpoint`` reads the port's own checkpoint directory;
- ``--tiny`` is an f32 configuration and the card's kernels take bf16: it
  runs on the CPU only;
- ``data.batch_size`` is one rank's batch (above); the stage-5 save and
  eval commands shard the head over ``n_model_shards`` ranks as training
  does, where the JAX CLI shards it in training only;
- an evaluation set is split over the data ranks, where each JAX process
  evaluates all of it and the gather counts every image once per process;
- stage 5's part head is one gather of each image's live columns (the JAX
  CLI's scatter-free "onehot" slice and its ``PD_HEAD_SLICE`` variable
  dodge a TPU fault and compute the same function);
- ``distill-eval`` merges the mapped labels over the GT part-label space,
  where the JAX package merges over [0, num_parts) and drops every mapped
  label >= num_parts (``models/meta_arch/part_distillation.py``);
- the train-batch overlays score the queries by a softmax in f32 (the JAX
  CLI's full-size default takes it in bf16);
- ``profile`` buckets the backward as one scope, ``backward``, and gives
  its split by the forward part it differentiates as a table of its own
  (``backward_by_scope``), where the JAX profile attributes each backward op
  to its forward scope in the buckets; it adds the device's idle time by
  span (``idle_by_span``); ``doctor`` reports torch's and CUDA's versions, the
  kernel build directory, the kernel library and the host codec in place
  of JAX's version, compile cache and native library;
- the supervised commands refuse weights whose tensors have other shapes
  than the model's (a checkpoint of the other ``--class-agnostic`` width),
  where the JAX CLI keeps the mismatched head's initialisation; their eval
  JSON line adds the images a second;
- the train JSON line adds the loader's wait and the step time per step and
  the time spent writing checkpoints; a checkpoint of the last step is
  written once;
- k-means is seeded per point set from its own id (``ops.kmeans
  .seed_uniforms``: the object class in ``rank``, the image id in
  ``propose``), where the JAX CLI splits one key per batch in ``propose``:
  the stores agree given the same centroids, not the same seed;
- ``rank``'s save phase counts the parts beyond ``--save-topk`` over the
  batch's real images (the JAX CLI also counts its padded slots);
- ``propose`` and ``eval-pixel-grouping`` load ``--torch-params`` (or a
  ``--trainer-checkpoint``) into the bare backbone by its ``backbone.*``
  keys;
- ``detect --clip-backend`` is ``device`` (the port's CLIP towers on
  ``--device``; the default) or ``torch`` (transformers on the host), and
  takes ``tpu`` as an alias of ``device``; ``detect`` and ``eval-detect``
  score queries by a softmax in f32 where the JAX CLI's full-size default
  takes it in bf16;
- ``detect``'s JSON line adds the seconds of its labelling loop and the
  images it processed a second (the JAX CLI prints the counts only);
- ``dcrf``'s default window stride is ``round(sxy / 5)``, 4 at sxy 20, as
  in both packages' code (the JAX CLI's help text says sxy / 2.5).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Optional

import numpy as np

logger = logging.getLogger("partdistillation_torch")

# ---------------------------------------------------------------- helpers


# the commands whose part head n_model_shards splits over a model group
_HEAD_SHARDED = ("train-distillation", "distill-save", "distill-eval")


def _setup(args):
    """The config, and ``args.mesh``: this rank's place in the (data,
    model) mesh of the process group (one rank without one)."""
    from .config import PipelineConfig, load_config
    from .parallel.mesh import make_mesh

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    cfg = load_config(PipelineConfig, getattr(args, "config", None), getattr(args, "set", None))
    try:
        args.mesh = make_mesh(n_model=cfg.n_model_shards if args.cmd in _HEAD_SHARDED else 1)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    return cfg


def _refuse_early(args) -> None:
    """Flags the port refuses, before any file or device is touched."""
    import torch

    if args.tiny and torch.device(args.device).type == "cuda":
        raise SystemExit("--tiny is the f32 smoke configuration and the card's kernels take "
                         "bf16: run it with --device cpu")
    if args.params:
        raise SystemExit("--params names an Orbax checkpoint, which cannot be read without "
                         "JAX; pass a torch state_dict with --torch-params instead")


def _tiny_swin():
    from .models.swin import SwinConfig

    return SwinConfig(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8),
                      window_size=4, drop_path_rate=0.0)


def _vitdet(tiny: bool, image_size: int):
    """ViTDet-L at ``image_size`` (bf16), or its tiny f32 form: its global
    blocks' position tables are sized for the image's token grid."""
    import torch

    from .models.vitdet import ViTDetConfig, vitdet_large_config

    if tiny:
        return ViTDetConfig(img_size=image_size, patch_size=16, embed_dim=32, depth=2,
                            num_heads=2, window_size=3, global_block_indexes=(1,),
                            pretrain_img_size=32, drop_path_rate=0.0, out_dim=32)
    return vitdet_large_config(img_size=image_size, dtype=torch.bfloat16)


def _msda(args) -> dict:
    """--msda-mode/--msda-band-radius -> PixelDecoderConfig kwargs."""
    kw = {}
    if getattr(args, "msda_mode", None):
        kw["msda_mode"] = args.msda_mode
    if getattr(args, "msda_band_radius", None) is not None:
        kw["msda_band_radius"] = args.msda_band_radius
    return kw


def _segmenter_cfg(tiny: bool, num_classes: int, num_queries: int,
                   num_object_classes: int = 0, num_parts: int = 8,
                   msda: Optional[dict] = None, freeze_trunk: bool = False,
                   backbone: str = "swin-l", image_size: int = 640):
    """The segmenter's configuration: Swin-L (``backbone`` "swin-l") or
    ViTDet-L at ``image_size`` ("vitdet-l"), the full-size default or the
    tiny f32 one."""
    import torch

    from .models.pixel_decoder import PixelDecoderConfig
    from .models.segmenter import SegmenterConfig
    from .models.swin import swin_large_config
    from .models.transformer_decoder import TransformerDecoderConfig

    msda = msda or {}
    bf16 = torch.bfloat16
    if backbone == "vitdet-l":
        trunk = {"vitdet": _vitdet(tiny, image_size)}
    else:
        trunk = {"swin": _tiny_swin() if tiny else swin_large_config(dtype=bf16)}
    if tiny:
        return SegmenterConfig(
            **trunk,
            pixel_decoder=PixelDecoderConfig(conv_dim=32, mask_dim=32, transformer_layers=1,
                                             transformer_ffn_dim=64, n_heads=4, n_points=2,
                                             **msda),
            decoder=TransformerDecoderConfig(num_classes=num_classes, hidden_dim=32,
                                             num_queries=num_queries, num_heads=4,
                                             dim_feedforward=64, dec_layers=2, mask_dim=32,
                                             num_object_classes=num_object_classes,
                                             num_parts=num_parts),
            freeze_backbone=freeze_trunk, freeze_pixel_decoder=freeze_trunk)
    # the full-size default: bf16 compute with f32 parameters, banded
    # sampling of radius 4 (exact while the offsets stay in band; the
    # counter is ops.ms_deform_attn.msda_band_oob_fraction)
    m = {"msda_mode": "banded", "msda_band_radius": 4, **msda}
    return SegmenterConfig(
        **trunk,
        pixel_decoder=PixelDecoderConfig(dtype=bf16, **m),
        decoder=TransformerDecoderConfig(num_classes=num_classes, num_queries=num_queries,
                                         dec_layers=9, dtype=bf16,
                                         num_object_classes=num_object_classes,
                                         num_parts=num_parts),
        freeze_backbone=freeze_trunk, freeze_pixel_decoder=freeze_trunk)


def _pack_train_batch(batch, mask_keys=("masks",), image_key="image"):
    """Host side of the wire format: uint8 image + bit-packed masks (8x fewer
    bytes to the device), in the profiler span ``data.pack``."""
    from torch.profiler import record_function

    from .utils.bitpack import pack_bits_np

    out = dict(batch)
    with record_function("data.pack"):
        if image_key in out:
            out[image_key] = np.clip(np.asarray(out[image_key]), 0, 255).astype(np.uint8)
        for k in mask_keys:
            if k in out:
                out[k] = pack_bits_np(np.asarray(out[k], bool))
    return out


def _unpack_train_batch(width: int, device, mask_keys=("masks",), image_key="image"):
    """Device side (the Trainer's ``batch_prepare``, the inference CLIs'
    uploads): the image to f32 and the masks unpacked to bool on ``device``."""
    import torch

    from .utils.bitpack import unpack_bits

    def prepare(batch):
        b = dict(batch)
        if image_key in b:
            b[image_key] = torch.as_tensor(b[image_key]).to(device).float()
        for k in mask_keys:
            if k in b:
                b[k] = unpack_bits(torch.as_tensor(b[k]).to(device), width)
        return b

    return prepare


class _StageTimer:
    """Per-stage timing: the first processed batch (model build, kernel build
    and first launches) apart from the steady-state rate."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.t1 = None
        self.n1 = 0
        self.n = 0

    def batch(self, n_images: int):
        self.n += n_images
        if self.t1 is None:
            self.t1 = time.perf_counter()
            self.n1 = self.n

    def stats(self) -> dict:
        t = time.perf_counter()
        total = t - self.t0
        out = {
            "total_s": round(total, 2),
            "images_per_sec": round(self.n / max(total, 1e-9), 3),
            "first_batch_s": round((self.t1 or t) - self.t0, 2),
        }
        if self.t1 is not None and t > self.t1 and self.n > self.n1:
            out["images_per_sec_steady"] = round((self.n - self.n1) / (t - self.t1), 3)
        return out


def _shard_id(args) -> tuple:
    """(index, count) of this rank's partition: ``--shard`` / ``--num-shards``
    when given, else the rank's data index of n_data (the ranks of one model
    group read the same items)."""
    if args.shard is not None:
        return args.shard, args.num_shards or 1
    return args.mesh.data_index, args.mesh.n_data


def _require_train_items(items: list, mesh) -> None:
    """Every data rank of a data-parallel run must hold items to train on:
    a rank without any would leave the others waiting in their first
    gradient all-reduce."""
    if mesh.n_data == 1:
        return
    from .engine.launch import all_gather_objects

    counts = all_gather_objects(len(items), mesh.data_group)
    if min(counts) == 0:
        raise SystemExit(f"train items per data rank: {counts}; every rank needs some (fewer "
                         "ranks, or more classes than data ranks)")


def _eval_share(items: list, mesh) -> list:
    """This data rank's strided share of an evaluation set."""
    return items[mesh.data_index::mesh.n_data]


def _gathered(mesh) -> dict:
    """An evaluator's keyword arguments: gather over the data ranks."""
    return {"distributed": mesh.n_data > 1, "group": mesh.data_group}


def _imagenet_items(cfg, args, object_store: Optional[str] = None):
    from .data.datasets.imagenet import load_imagenet

    shard, num_shards = _shard_id(args)
    return load_imagenet(
        cfg.data.imagenet_root,
        partition_index=shard if num_shards > 1 else None,
        total_partitions=num_shards if num_shards > 1 else None,
        object_mask_store=object_store,
        debug_limit=cfg.data.debug_limit,
        vocab_map=cfg.data.vocab_map or None,
        manifest=cfg.data.manifest or None,
    )


def _checkpoint_file(path: str) -> str:
    """The newest ``model_*.pt`` of a Trainer checkpoint directory (or the file)."""
    if os.path.isfile(path):
        return path
    found = sorted(f for f in os.listdir(path) if f.startswith("model_") and f.endswith(".pt")) \
        if os.path.isdir(path) else []
    if not found:
        raise SystemExit(f"no trainer checkpoint found in {path}")
    return os.path.join(path, found[-1])


def _load_weights(model, args, require_weights: bool = False, prefix: str = "",
                  exact_shapes: bool = False) -> None:
    """Model weights for the CLIs: ``--torch-params`` (a state_dict, or a dict
    holding one under "model" / "state_dict"; keys the model lacks are
    skipped), ``--trainer-checkpoint`` (the newest step of a port Trainer
    directory: every parameter whose name and shape match is taken, the rest
    keep their initialisation), or the seeded initialisation, which an eval
    command takes only with ``--allow-random-init``. With ``prefix`` only
    the keys under it are read, without it (a segmenter's ``backbone.``
    into a bare backbone). ``exact_shapes`` refuses weights whose tensors
    have other shapes than the model's instead of skipping them."""
    import torch

    sources = [s for s in (args.params, args.trainer_checkpoint, args.torch_params) if s]
    if len(sources) > 1:
        raise SystemExit("--params, --trainer-checkpoint and --torch-params "
                         "are mutually exclusive")
    if require_weights and not sources:
        if not args.allow_random_init:
            raise SystemExit(
                "this command evaluates with model weights but none were given: pass "
                "--trainer-checkpoint or --torch-params (or --allow-random-init to "
                "knowingly run with random weights)")
        logger.warning("RUNNING WITH RANDOM WEIGHTS (--allow-random-init): "
                       "all outputs/metrics below are meaningless for quality")
    if not sources:
        return
    path = args.torch_params or _checkpoint_file(args.trainer_checkpoint)
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and isinstance(state.get("model"), dict):
        state = state["model"]
    elif isinstance(state, dict) and isinstance(state.get("state_dict"), dict):
        state = state["state_dict"]
    if prefix:
        state = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    own = model.state_dict()
    take = {k: v for k, v in state.items()
            if k in own and tuple(v.shape) == tuple(own[k].shape)}
    other = sorted(k for k in state if k in own and k not in take)
    if exact_shapes and other:
        raise SystemExit(f"{path} holds tensors of other shapes than this model's (e.g. "
                         f"{other[0]}: {tuple(state[other[0]].shape)} there, "
                         f"{tuple(own[other[0]].shape)} here): weights of another head width, "
                         "e.g. trained with the other --class-agnostic setting; refusing a "
                         "partial load")
    if not take:
        raise SystemExit(f"{path} matches this model at no parameter; refusing to continue "
                         "with a fully fresh init")
    model.load_state_dict(take, strict=False)
    logger.info("loaded %d of %d tensors from %s (%d of the checkpoint's skipped)",
                len(take), len(own), path, len(state) - len(take))


# ---------------------------------------------------------------- eval datasets


def _eval_catalog(cfg, args):
    """The GT part datasets: part_imagenet, pascal and cityscapes (the
    reference's TEST sets), their loaders lazy. Each carries its eval
    contract in ``Metadata.extra``: the mapper's keyword arguments, the GT
    part count and the object-class count. Pascal's come from parsing its
    annotations, so its loader fills them when it first runs (None before)."""
    from .data.catalog import DatasetCatalog, Metadata

    cat = DatasetCatalog()

    def load_pi():
        from .data.datasets.part_imagenet import load_part_imagenet

        return load_part_imagenet(cfg.data.part_imagenet_json, cfg.data.part_imagenet_images,
                                  debug_limit=cfg.data.debug_limit)

    cat.register("part_imagenet", load_pi, Metadata(
        name="part_imagenet",
        extra={"mapper_kwargs": {}, "n_gt_parts": getattr(args, "num_gt_parts", 40),
               "num_obj_classes": None}))

    def need_dir(name: str, key: str, path: str) -> None:
        if not os.path.isdir(path):
            raise SystemExit(f"--eval-dataset {name}: {key}={path!r} is not a directory")

    def load_pascal():
        from .data.datasets.pascal_parts import load_pascal_parts
        from .data.mappers import PartEvalMapper

        need_dir("pascal", "data.pascal_parts_annotations", cfg.data.pascal_parts_annotations)
        raw = load_pascal_parts(cfg.data.pascal_parts_annotations, cfg.data.pascal_parts_images,
                                debug_limit=cfg.data.debug_limit)
        vocab = PartEvalMapper.pascal_vocab(raw)
        class_names = sorted({o["class_name"] for it in raw for o in it["objects"]})
        cid = {c: i for i, c in enumerate(class_names)}
        items = []
        for it in raw:  # one item per (image, object class)
            by_cls = {}
            for o in it["objects"]:
                by_cls.setdefault(o["class_name"], []).append(o)
            for cname, objs in sorted(by_cls.items()):
                entry = {k: v for k, v in it.items() if k != "objects"}
                entry.update(image_id=f"{it['image_id']}:{cname}", objects=objs,
                             class_id=cid[cname])
                items.append(entry)
        md = cat.get("pascal").metadata
        md.class_names = class_names
        md.extra.update(mapper_kwargs={"part_vocab": vocab}, n_gt_parts=max(len(vocab), 1),
                        num_obj_classes=len(class_names))
        return items

    cat.register("pascal", load_pascal, Metadata(
        name="pascal", extra={"mapper_kwargs": None, "n_gt_parts": None,
                              "num_obj_classes": None}))

    from .data.datasets.cityscapes_part import (CITYSCAPES_NUM_PART_CLASSES,
                                                CITYSCAPES_PART_SIDS, load_cityscapes_part)

    def load_cs():
        need_dir("cityscapes", "data.cityscapes_part_labels", cfg.data.cityscapes_part_labels)
        raw = load_cityscapes_part(cfg.data.cityscapes_part_labels, cfg.data.cityscapes_images,
                                   debug_limit=cfg.data.debug_limit)
        sids = sorted(CITYSCAPES_PART_SIDS)
        return [dict(it, image_id=f"{it['image_id']}:{s}", sid=s, class_id=i)
                for it in raw for i, s in enumerate(sids)]

    cat.register("cityscapes", load_cs, Metadata(
        name="cityscapes",
        extra={"mapper_kwargs": {}, "n_gt_parts": CITYSCAPES_NUM_PART_CLASSES,
               "num_obj_classes": len(CITYSCAPES_PART_SIDS)}))
    return cat


def _load_eval_items(cfg, args) -> dict:
    """``--eval-dataset``: {name, items, mapper_kwargs, n_gt_parts,
    num_obj_classes}. Pascal and cityscapes items carry a dataset-local
    ``class_id`` (one item per image and object class); part_imagenet items
    keep their synset ``class_code``."""
    name = getattr(args, "eval_dataset", "part_imagenet")
    cat = _eval_catalog(cfg, args)
    if name not in cat:
        raise SystemExit(f"unknown --eval-dataset {name!r} "
                         f"(choose one of {', '.join(cat.names())})")
    spec = cat.get(name)
    items = spec.items()
    return {"name": name, "items": items, **spec.metadata.extra}


def _assign_eval_class_ids(cfg, ds: dict, num_obj: int) -> list:
    """Give every eval item the object-class id that indexes the model's
    per-class state (the centroid bank, the part head, the vote mapping).
    PartImageNet: its synset through the ImageNet root's global vocabulary
    (the ids the head was trained with); items outside the ``num_obj``-class
    vocabulary are dropped. Pascal and cityscapes: the dataset-local ids
    they carry, which the model's ``num_obj`` classes must cover."""
    items = ds["items"]
    if ds["name"] != "part_imagenet":
        n_local = ds["num_obj_classes"] or 1
        if n_local > num_obj:
            raise SystemExit(f"{ds['name']} has {n_local} object classes but the model covers "
                             f"{num_obj}; re-run the cluster / train phase on this dataset or "
                             "raise --num-object-classes")
        return items
    from .data.datasets.imagenet import global_code_to_id

    try:
        code_to_id = global_code_to_id(cfg.data.imagenet_root, cfg.data.vocab_map or None,
                                       cfg.data.manifest or None)
    except FileNotFoundError:
        code_to_id = {}
    if not code_to_id:
        logger.warning("imagenet_root unavailable; falling back to eval-local class ids "
                       "(only valid if the eval set's sorted codes match the training "
                       "vocabulary)")
        codes = sorted({it["class_code"] for it in items})
        code_to_id = {c: i for i, c in enumerate(codes)}
    n_before = len(items)
    items = [it for it in items if code_to_id.get(it["class_code"], num_obj) < num_obj]
    if len(items) < n_before:
        logger.warning("eval: dropped %d items outside the %d-class object vocabulary",
                       n_before - len(items), num_obj)
    for it in items:
        it["class_id"] = code_to_id[it["class_code"]]
    return items


# ---------------------------------------------------------------- stage 1


def cmd_label(args):
    """Stage 1 from a store of precomputed detections: class match, top-k,
    RLE records in ``paths.object_labels``."""
    cfg = _setup(args)
    from .data.pseudo_store import ShardWriter
    from .models.meta_arch.labeling import LabelingConfig, precomputed_detector, run_labeling

    items = _imagenet_items(cfg, args)
    writer = ShardWriter(cfg.paths.object_labels, *_shard_id(args))
    try:
        stats = run_labeling(precomputed_detector(args.detections), items, writer,
                             LabelingConfig(topk=args.topk, score_threshold=args.score_threshold,
                                            match_classes=not args.no_class_match))
    finally:
        writer.close()
    print(json.dumps({"stage": "label", **stats}))


def _detection_setup(cfg, args, device, topk: int):
    """The class-agnostic segmenter (one class, ``--num-queries``) with its
    weights, and its detection forward keeping ``topk`` masks an image."""
    from .models.meta_arch.labeling import make_proposal_detection_fn
    from .models.meta_arch.proposal import ProposalModelConfig
    from .models.segmenter import MaskFormerSegmenter

    seg = _segmenter_cfg(args.tiny, num_classes=1, num_queries=args.num_queries,
                         msda=_msda(args))
    model = MaskFormerSegmenter(seg, device=device, seed=cfg.seed)
    _load_weights(model, args, require_weights=True)
    model_cfg = ProposalModelConfig(segmenter=seg, test_topk=min(topk, args.num_queries))
    return model_cfg, make_proposal_detection_fn(model_cfg, model, device=device)


def cmd_detect(args):
    """Stage 1 from pixels: the class-agnostic segmenter's mask proposals,
    scored by CLIP over the ImageNet vocabulary when ``--clip-model`` names a
    local checkpoint, written to ``paths.object_labels``."""
    cfg = _setup(args)
    from . import resolve_device
    from .data.pseudo_store import ShardWriter
    from .models.meta_arch.labeling import LabelingConfig, run_labeling_batched

    device = resolve_device(args.device)
    items = _imagenet_items(cfg, args)
    _, detection_fn = _detection_setup(cfg, args, device, args.proposals)
    scorer = None
    if args.clip_model:
        from .data.datasets.imagenet import global_code_to_id, read_class_names
        from .models.meta_arch.labeling import clip_region_scorer, load_clip_region_scorer

        code_to_id = global_code_to_id(cfg.data.imagenet_root, cfg.data.vocab_map or None,
                                       cfg.data.manifest or None)
        names = read_class_names(cfg.data.imagenet_root)
        vocab = [names.get(c, c) for c in sorted(code_to_id)]
        if args.clip_backend == "torch":
            scorer = clip_region_scorer(args.clip_model, vocab)
        else:  # the port's towers on the device; bf16 at full size, as JAX's
            import torch

            dtype = torch.float32 if args.tiny else torch.bfloat16
            scorer = load_clip_region_scorer(args.clip_model, vocab, dtype=dtype, device=device)
        logger.info("CLIP region scorer (%s) over %d classes", args.clip_backend, len(vocab))
    writer = ShardWriter(cfg.paths.object_labels, *_shard_id(args))
    t0 = time.perf_counter()
    try:
        stats = run_labeling_batched(
            detection_fn, items, writer,
            LabelingConfig(topk=args.topk, score_threshold=args.score_threshold,
                           match_classes=scorer is not None and not args.no_class_match),
            region_scorer=scorer, image_size=cfg.data.image_size,
            batch_size=cfg.data.batch_size, num_workers=cfg.data.num_workers)
    finally:
        writer.close()
    total = time.perf_counter() - t0
    done = stats["saved"] + stats["empty"]
    print(json.dumps({"stage": "detect", **stats, "total_s": round(total, 2),
                      "images_per_sec": round(done / max(total, 1e-9), 3)}))


def cmd_eval_detect(args):
    """Stage-1 detection quality: AR@k of the ``detect`` proposals against
    the object ground truth (one silhouette an image)."""
    cfg = _setup(args)
    from . import resolve_device
    from .data.loader import batch_iterator
    from .data.mappers import PartEvalMapper
    from .engine.metrics import print_csv_format
    from .evaluation.proposal_evaluator import ProposalEvaluator

    device = resolve_device(args.device)
    ds = _load_eval_items(cfg, args)
    model_cfg, detection_fn = _detection_setup(cfg, args, device, args.topk)
    mapper = PartEvalMapper(image_size=cfg.data.image_size, capacity=16,
                            merge_parts_by_class=False, **ds["mapper_kwargs"])
    limits = tuple(l for l in (1, 10, 50, 100) if l <= model_cfg.test_topk)
    evaluator = ProposalEvaluator(limits=limits or (model_cfg.test_topk,),
                                  **_gathered(args.mesh))
    for batch in batch_iterator(_eval_share(ds["items"], args.mesh), mapper,
                                cfg.data.batch_size, num_workers=cfg.data.num_workers):
        out = _to_host(detection_fn(batch["image"]))
        bv = batch["batch_valid"]
        gt = batch["object_mask"][:, None]  # the object silhouette, one instance an image
        gt_valid = gt.reshape(gt.shape[0], 1, -1).any(-1)
        evaluator.process({"pred_masks": out["masks"][bv], "scores": out["scores"][bv],
                           "valid": out["valid"][bv]}, gt[bv], gt_valid[bv])
    metrics = evaluator.evaluate()
    print_csv_format(metrics, task="eval-detect")
    print(json.dumps({"stage": "eval-detect", "dataset": ds["name"], **metrics}))


# ---------------------------------------------------------------- stage 2


def _generation_setup(cfg, args, device):
    """The stage-2 config and ``make_generation_fn`` on the bare Swin
    backbone (Swin-L bf16 at full size), its weights loaded."""
    import torch

    from .models.meta_arch.proposal_generation import (ProposalGenerationConfig,
                                                       make_backbone, make_generation_fn)
    from .models.swin import swin_large_config

    gen_cfg = ProposalGenerationConfig(
        swin=_tiny_swin() if args.tiny else swin_large_config(dtype=torch.bfloat16),
        num_clusters=args.num_clusters)
    backbone = make_backbone(gen_cfg.swin, device=device, seed=cfg.seed)
    _load_weights(backbone, args, require_weights=True, prefix="backbone.")
    return gen_cfg, make_generation_fn(gen_cfg, backbone, device=device)


def cmd_propose(args):
    """Stage 2: k-means part proposals inside each image's stage-1 object
    mask, written to ``paths.proposals``; images already in the store are
    skipped (resume), and the shard is marked complete at the end."""
    cfg = _setup(args)
    from . import resolve_device
    from .data.loader import batch_iterator
    from .data.mappers import ProposalGenerationMapper
    from .data.pseudo_store import ShardWriter, mark_shard_complete
    from .ops.kmeans import seed_uniforms
    from .utils import rle as rle_codec
    from .utils.bitpack import pack_bits, unpack_bits_np

    device = resolve_device(args.device)
    shard, num_shards = _shard_id(args)
    items = _imagenet_items(cfg, args, object_store=cfg.paths.object_labels)
    writer = ShardWriter(cfg.paths.proposals, shard, num_shards)
    items = [it for it in items if it["image_id"] not in writer]
    logger.info("stage 2: %d images to process", len(items))

    _, gen_fn = _generation_setup(cfg, args, device)
    size = cfg.data.image_size
    prepare = _unpack_train_batch(size, device, mask_keys=("object_mask",))
    mapper = ProposalGenerationMapper(image_size=size)
    n_saved, n_batches, timer = 0, 0, _StageTimer()
    try:
        for batch in batch_iterator(items, mapper, cfg.data.batch_size,
                                    num_workers=cfg.data.num_workers):
            wire = prepare(_pack_train_batch(
                {k: batch[k] for k in ("image", "object_mask")}, mask_keys=("object_mask",)))
            out = gen_fn(wire, seed_uniforms(cfg.seed, batch["image_id"], args.num_clusters))
            masks = unpack_bits_np(pack_bits(out["part_masks"]).cpu().numpy(), size)
            valid = out["part_valid"].cpu().numpy()
            ratio = out["object_ratio"].cpu().numpy()
            for b in range(masks.shape[0]):
                if not batch["batch_valid"][b]:
                    continue
                rles = [rle_codec.encode(masks[b, k]) for k in range(masks.shape[1])
                        if valid[b, k]]
                if not rles:
                    continue
                n_saved += int(writer.write({
                    "image_id": str(batch["image_id"][b]),
                    "part_masks": rles,
                    "object_ratio": float(ratio[b]),
                    "object_class": int(batch["class_id"][b]),
                }))
            n_batches += 1
            timer.batch(int(np.sum(batch["batch_valid"])))
            if n_batches % 20 == 0:
                writer.flush()
    finally:
        writer.close()
    # completion marker: a concurrent dCRF consumer stops once every shard is done
    mark_shard_complete(cfg.paths.proposals, shard, num_shards)
    print(json.dumps({"stage": "propose", "saved": n_saved, **timer.stats()}))


def cmd_eval_pixel_grouping(args):
    """Stage-2 clustering quality: AR@k of the k-means proposals against the
    GT part instances (the reference's pixel_grouping_test_net.py)."""
    cfg = _setup(args)
    from . import resolve_device
    from .data.datasets.part_imagenet import load_part_imagenet
    from .data.loader import batch_iterator
    from .data.mappers import PartEvalMapper
    from .engine.metrics import print_csv_format
    from .evaluation.proposal_evaluator import ProposalEvaluator
    from .ops.kmeans import seed_uniforms

    device = resolve_device(args.device)
    items = load_part_imagenet(cfg.data.part_imagenet_json, cfg.data.part_imagenet_images,
                               debug_limit=cfg.data.debug_limit)
    _, gen_fn = _generation_setup(cfg, args, device)
    mapper = PartEvalMapper(image_size=cfg.data.image_size, capacity=16,
                            merge_parts_by_class=False)
    evaluator = ProposalEvaluator(limits=(1, 10, 50, 100), **_gathered(args.mesh))
    timer = _StageTimer()
    for batch in batch_iterator(_eval_share(items, args.mesh), mapper, cfg.data.batch_size,
                                num_workers=cfg.data.num_workers):
        out = _to_host(gen_fn({"image": batch["image"], "object_mask": batch["object_mask"]},
                              seed_uniforms(cfg.seed, batch["image_id"], args.num_clusters)))
        bv = batch["batch_valid"]
        evaluator.process({"pred_masks": out["part_masks"][bv],
                           "scores": np.ones(out["part_valid"].shape, np.float32)[bv],
                           "valid": out["part_valid"][bv]},
                          batch["gt_part_masks"][bv], batch["gt_valid"][bv])
        timer.batch(int(np.sum(bv)))
    metrics = evaluator.evaluate()
    print_csv_format(metrics, task="eval-pixel-grouping")
    print(json.dumps({"stage": "eval-pixel-grouping", **metrics, **timer.stats()}))


# ---------------------------------------------------------------- stage 2b


def make_refine_fn(params, capacity: int, size: int, device):
    """The dCRF's device step: ``refine(image_u8, masks_packed, valid)`` ->
    (the refined masks bit-packed (B, capacity, size, ceil(size / 8)) uint8,
    their validity (B, capacity)), on ``device``. A refined mask is the
    pixels whose most probable label is its own, kept where the input slot
    was valid and the result is non-empty."""
    import torch

    from .ops.dense_crf import dense_crf, unary_from_masks
    from .utils.bitpack import pack_bits, unpack_bits

    labels = 1 + torch.arange(capacity, device=device)[:, None, None]

    def refine(image_u8, masks_packed, valid):
        with torch.inference_mode():
            image = torch.as_tensor(image_u8).to(device).float()
            masks = unpack_bits(torch.as_tensor(masks_packed).to(device), size)
            valid = torch.as_tensor(valid).to(device)
            q = dense_crf(image, unary_from_masks(masks, valid, params.gt_prob), params)
            refined = q.argmax(-1)[:, None] == labels
            return pack_bits(refined), refined.any(dim=(2, 3)) & valid

    return refine


def cmd_dcrf(args):
    """Stage 2b: dense-CRF smoothing of the stage-2 proposals into
    ``paths.proposals_dcrf``; images written before are skipped. With
    ``--watch`` it rescans the stage-2 store every ``--watch-interval``
    seconds until every stage-2 shard is marked complete, then drains once
    more and exits."""
    cfg = _setup(args)
    from . import resolve_device
    from .data.datasets.imagenet import load_imagenet_with_proposals
    from .data.loader import batch_iterator
    from .data.mappers import PartRankingMapper, invalidate_store_cache
    from .data.pseudo_store import ShardWriter, store_complete
    from .ops.dense_crf import DenseCRFParams
    from .utils import rle as rle_codec
    from .utils.bitpack import pack_bits_np, unpack_bits_np

    device = resolve_device(args.device)
    shard, num_shards = _shard_id(args)
    base = _imagenet_items(cfg, args)
    writer = ShardWriter(cfg.paths.proposals_dcrf, shard, num_shards)
    params = DenseCRFParams(gt_prob=args.gt_prob, iters=args.iters,
                            bilateral_sxy=args.bilateral_sxy,
                            bilateral_stride=args.bilateral_stride)
    capacity, size = cfg.data.mask_capacity, cfg.data.image_size
    refine = make_refine_fn(params, capacity, size, device)
    mapper = PartRankingMapper(image_size=size, capacity=capacity)
    # images whose refinement keeps no mask leave no record; remember them so
    # that --watch's rescans do not refine them again
    refined_empty: set = set()
    timer = _StageTimer()

    def one_pass() -> int:
        """Refine every stage-2 record not written yet."""
        invalidate_store_cache(cfg.paths.proposals)  # late shards must show
        items = load_imagenet_with_proposals(base, cfg.paths.proposals)
        items = [it for it in items
                 if it["image_id"] not in writer and it["image_id"] not in refined_empty]
        if not items:
            return 0
        logger.info("stage 2b dCRF: %d images", len(items))
        n_saved, n_batches = 0, 0
        for batch in batch_iterator(items, mapper, cfg.data.batch_size,
                                    num_workers=cfg.data.num_workers):
            packed, valid = refine(np.clip(batch["image"], 0, 255).astype(np.uint8),
                                   pack_bits_np(batch["part_masks"]), batch["part_valid"])
            refined = unpack_bits_np(packed.cpu().numpy(), size)
            valid = valid.cpu().numpy()
            timer.batch(int(np.sum(batch["batch_valid"])))
            for b in range(refined.shape[0]):
                if not batch["batch_valid"][b]:
                    continue
                rles = [rle_codec.encode(refined[b, k]) for k in range(capacity) if valid[b, k]]
                if not rles:
                    refined_empty.add(str(batch["image_id"][b]))
                    continue
                n_saved += int(writer.write({
                    "image_id": str(batch["image_id"][b]),
                    "part_masks": rles,
                    "object_ratio": float(refined[b][valid[b]].any(0).mean()),
                    "object_class": int(batch["class_id"][b]),
                }))
            n_batches += 1
            if n_batches % 20 == 0:
                writer.flush()
        writer.flush()
        return n_saved

    n_saved = 0
    try:
        while True:
            n_saved += one_pass()
            if not args.watch:
                break
            if store_complete(cfg.paths.proposals):
                # the stage-2 writers close before they mark completion, so
                # one more pass sees every record
                n_saved += one_pass()
                logger.info("stage 2b dCRF --watch: upstream complete and drained")
                break
            time.sleep(args.watch_interval)
    finally:
        writer.close()
    print(json.dumps({"stage": "dcrf", "saved": n_saved, **timer.stats()}))


# ---------------------------------------------------------------- stage 3


def _make_vis_fn(model, vis_dir: str, device, needs_object_class: bool = False,
                 topk: int = 6, max_images: int = 4):
    """In-train overlay snapshots (the reference's VIS_PERIOD): the live
    model's top-``topk`` predicted masks of the first ``max_images`` images
    of the train batch (left) beside the batch's targets (right), one
    collage PNG a call, ``step_{step:06d}.png`` in ``vis_dir``. Queries are
    ranked by their best non-void softmax probability (ties to the lower
    index, as ``lax.top_k``), their mask logits resized to the image by
    JAX's ``linear`` weights and thresholded at 0. ``vis_fn(batch, step)``
    takes the host batch (uint8-valued image, bool masks); every rank runs
    the forward (the stage-5 head may be split over a model group), rank 0
    writes."""
    import torch

    from .engine.launch import is_main_process
    from .models.meta_arch.proposal import normalize_images
    from .ops.instance_post import stable_topk
    from .ops.resize import resize, triangle_kernel
    from .utils.visualize import make_collage, overlay_masks, save_image

    def predict(images: torch.Tensor, gt_object_class: torch.Tensor) -> torch.Tensor:
        kwargs = {"gt_object_class": gt_object_class} if needs_object_class else {}
        with torch.no_grad():
            out = model(normalize_images(images), **kwargs)
            probs = torch.softmax(out["pred_logits"].float(), dim=-1)[..., :-1].amax(-1)
            _, idx = stable_topk(probs, min(topk, probs.shape[-1]))
            masks = out["pred_masks"]
            masks = torch.gather(masks, 1, idx[:, :, None, None].expand(
                -1, -1, *masks.shape[2:]))
            h, w = images.shape[1:3]
            masks = resize(masks.permute(0, 2, 3, 1), h, w, triangle_kernel)
            return (masks > 0.0).permute(0, 3, 1, 2).cpu().numpy()

    def vis_fn(batch, step: int) -> None:
        n = min(max_images, len(batch["image"]))
        images = np.asarray(batch["image"][:n], np.float32)
        goc = np.asarray(batch.get("gt_object_class", np.zeros(n)), np.int64)[:n]
        masks = predict(torch.as_tensor(images, device=device),
                        torch.as_tensor(goc, device=device))
        if not is_main_process():
            return
        gt = batch.get("masks", batch.get("part_masks"))
        gt_valid = batch.get("valid", batch.get("part_valid"))
        panels = []
        for i in range(n):
            panels.append(overlay_masks(images[i], masks[i]))
            if gt is not None:
                panels.append(overlay_masks(images[i], np.asarray(gt[i]) > 0.5,
                                            valid=np.asarray(gt_valid[i]) > 0))
        os.makedirs(vis_dir, exist_ok=True)
        save_image(os.path.join(vis_dir, f"step_{step:06d}.png"),
                   make_collage(panels, cols=2))

    return vis_fn


def _vis_fn(cfg, stage: str, model, device, needs_object_class: bool = False):
    """The stage's overlay hook when ``vis_every > 0``, else None."""
    if cfg.vis_every <= 0:
        return None
    return _make_vis_fn(model, os.path.join(cfg.checkpoint_dir, "logs", stage, "vis"), device,
                        needs_object_class=needs_object_class)


def _train_loop(cfg, trainer, loader, stage: str, eval_fn=None, vis_fn=None):
    """Hot loop: one train step per batch (the metrics' readback is the
    step's sync), metrics.jsonl every ``log_every`` steps, the held-out
    evaluation every ``eval_every``, the train batch's overlays
    (``vis_fn(batch, step)``) every ``vis_every``, a checkpoint every
    ``checkpoint_every`` and at the end. Besides the JAX CLI's keys it returns the loader's wait
    (the next batch and its packing into the wire format) and the step time,
    each a mean over the steps after the first (and, data parallel, the
    gradient all-reduce's), the share of batches asked for while the
    loader's queue was empty (``loader_empty_share``), and the seconds spent
    writing checkpoints inside the loop."""
    from .engine.metrics import MetricLogger

    mlog = MetricLogger(os.path.join(cfg.checkpoint_dir, "logs", stage), run_name=stage)
    t0 = time.perf_counter()
    n_img = 0
    timer = _StageTimer()
    waits, steps, syncs, saving, saved = [], [], [], 0.0, None
    batches = iter(loader)
    try:
        while True:
            tw = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            raw = batch
            batch = _pack_train_batch({k: v for k, v in batch.items() if k != "image_id"})
            ts = time.perf_counter()
            metrics = trainer.train_step(batch)
            waits.append(ts - tw)
            steps.append(time.perf_counter() - ts)
            if "grad_sync_s" in metrics:
                syncs.append(metrics["grad_sync_s"])
            n_valid = int(np.asarray(batch["batch_valid"]).sum())
            timer.batch(n_valid)
            n_img += n_valid
            step = trainer.step
            if vis_fn is not None and step % cfg.vis_every == 0:
                # the image as the step saw it: packed to uint8 on the wire
                vis_fn(dict(raw, image=batch["image"]), step)
            if step % cfg.log_every == 0:
                ips = n_img / (time.perf_counter() - t0)
                logger.info("%s step %d: loss=%.4f grad=%.3f %.2f img/s", stage, step,
                            metrics.get("total_loss", float("nan")),
                            metrics.get("grad_norm", float("nan")), ips)
                mlog.log({**metrics, "images_per_sec": ips}, step)
            if eval_fn is not None and cfg.eval_every > 0 and step % cfg.eval_every == 0:
                emetrics = {f"eval/{k}": float(v) for k, v in (eval_fn() or {}).items()
                            if isinstance(v, (int, float, np.floating))}
                logger.info("%s step %d eval: %s", stage, step, emetrics)
                mlog.log(emetrics, step)
            if trainer.checkpoint_dir is not None and step % cfg.checkpoint_every == 0:
                tc = time.perf_counter()
                trainer.save()
                saving, saved = saving + time.perf_counter() - tc, step
            if step >= cfg.max_iters:
                break
        stats = timer.stats()
        elapsed = time.perf_counter() - t0
        taken = loader.stats()
    finally:
        loader.close()
    if trainer.checkpoint_dir is not None and trainer.step != saved:
        trainer.save()
    mlog.close()
    steady = slice(1, None) if len(steps) > 1 else slice(None)
    return {"steps": trainer.step,
            "images_per_sec": round(n_img / max(elapsed, 1e-9), 3),
            **{k: v for k, v in stats.items() if k != "images_per_sec"},
            "loader_wait_s": round(float(np.mean(waits[steady])), 5) if waits else None,
            "step_s": round(float(np.mean(steps[steady])), 5) if steps else None,
            "loader_empty_share": (round(taken["taken_empty"] / taken["taken"], 5)
                                   if taken["taken"] else None),
            **({"grad_sync_s": round(float(np.mean(syncs[steady])), 5)} if syncs else {}),
            "checkpoint_s": round(saving, 3)}


def _proposal_ar_eval(cfg, model_cfg, model, device, ds, mesh) -> dict:
    """AR@k of the ProposalModel on a GT part dataset (``make_inference_fn``
    -> ``ProposalEvaluator``), this data rank's share of it, gathered over
    the data ranks. Leaves the model in the mode it found it in."""
    from .data.loader import batch_iterator
    from .data.mappers import PartEvalMapper
    from .evaluation.proposal_evaluator import ProposalEvaluator
    from .models.meta_arch.proposal import make_inference_fn

    training = model.training
    # AR is class-agnostic over part *instances*: keep instances separate
    mapper = PartEvalMapper(image_size=cfg.data.image_size, capacity=16,
                            merge_parts_by_class=False, **ds["mapper_kwargs"])
    infer_fn = make_inference_fn(model_cfg, model, device=device)
    limits = tuple(l for l in (1, 10, 50, 100, 200) if l <= model_cfg.test_topk)
    evaluator = ProposalEvaluator(limits=limits or (model_cfg.test_topk,), **_gathered(mesh))
    for batch in batch_iterator(_eval_share(ds["items"], mesh), mapper, cfg.data.batch_size,
                                num_workers=cfg.data.num_workers):
        out = infer_fn({
            "image": batch["image"],
            "part_masks": batch["gt_part_masks"],
            "part_labels": batch["gt_part_labels"],
            "part_valid": batch["gt_valid"],
            "object_masks": batch["object_mask"][:, None],
            "object_valid": np.ones((batch["object_mask"].shape[0], 1), bool),
        })
        bv = batch["batch_valid"]
        evaluator.process(
            {k: (out[k].float() if out[k].is_floating_point() else out[k]).cpu().numpy()[bv]
             for k in ("pred_masks", "scores", "valid")},
            batch["gt_part_masks"][bv], batch["gt_valid"][bv])
    model.train(training)
    return evaluator.evaluate()


def cmd_train_proposal(args):
    cfg = _setup(args)
    from . import resolve_device
    from .data.datasets.imagenet import load_imagenet_with_proposals
    from .data.loader import DataLoader
    from .data.mappers import ProposalTrainMapper
    from .engine.optim import OptimizerConfig
    from .engine.trainer import Trainer
    from .losses.criterion import CriterionConfig
    from .losses.matcher import MatcherConfig
    from .models.meta_arch.proposal import ProposalModelConfig, make_loss_fn
    from .models.segmenter import MaskFormerSegmenter

    device = resolve_device(args.device)
    base = _imagenet_items(cfg, args)
    items = load_imagenet_with_proposals(
        base, cfg.paths.proposals if args.raw_proposals else cfg.paths.proposals_dcrf)
    logger.info("stage 3: %d train items in this process", len(items))
    _require_train_items(items, args.mesh)

    seg = _segmenter_cfg(args.tiny, num_classes=1, num_queries=args.num_queries,
                         msda=_msda(args), freeze_trunk=args.freeze_trunk)
    n_pts = 1024 if args.tiny else 12544
    model_cfg = ProposalModelConfig(
        segmenter=seg, criterion=CriterionConfig(num_classes=1, num_points=n_pts,
                                                 matcher=MatcherConfig(num_points=n_pts)))
    model = MaskFormerSegmenter(seg, device=device, seed=cfg.seed)
    # a warm start from another run; this run's own checkpoints still win
    # through resume_or_load below
    _load_weights(model, args)
    size = cfg.data.image_size
    trainer = Trainer(
        make_loss_fn(model_cfg, model, device=device, group=args.mesh.data_group), model,
        OptimizerConfig(freeze_keys=("backbone", "pixel_decoder") if args.freeze_trunk else ()),
        device=device, seed=cfg.seed, checkpoint_dir=os.path.join(cfg.checkpoint_dir, "proposal"),
        # wire format: uint8 images and bit-packed masks, unpacked on the device
        batch_prepare=_unpack_train_batch(size, device), mesh=args.mesh)
    trainer.resume_or_load()

    mapper = ProposalTrainMapper(image_size=size, capacity=cfg.data.mask_capacity,
                                 seed=cfg.seed)
    loader = DataLoader(items, mapper, cfg.data.batch_size, shuffle=True, seed=cfg.seed,
                        epochs=None, num_workers=cfg.data.num_workers, drop_last=True)
    eval_fn = None
    if cfg.eval_every > 0:
        import dataclasses

        ds = _load_eval_items(cfg, args)
        infer_cfg = dataclasses.replace(model_cfg,
                                        test_topk=min(model_cfg.test_topk, args.num_queries))
        eval_fn = lambda: _proposal_ar_eval(cfg, infer_cfg, model, device, ds,  # noqa: E731
                                            args.mesh)
    stats = _train_loop(cfg, trainer, loader, "train-proposal", eval_fn=eval_fn,
                        vis_fn=_vis_fn(cfg, "train-proposal", model, device))
    print(json.dumps({"stage": "train-proposal", **stats}))


def cmd_eval_proposal(args):
    """Stage-3 AR evaluation of a ProposalModel."""
    cfg = _setup(args)
    from . import resolve_device
    from .engine.metrics import print_csv_format
    from .models.meta_arch.proposal import ProposalModelConfig
    from .models.segmenter import MaskFormerSegmenter

    device = resolve_device(args.device)
    ds = _load_eval_items(cfg, args)
    seg = _segmenter_cfg(args.tiny, num_classes=1, num_queries=args.num_queries,
                         msda=_msda(args))
    model_cfg = ProposalModelConfig(segmenter=seg, test_topk=min(args.topk, args.num_queries),
                                    use_unique_per_pixel_label=not args.no_unique_assignment)
    model = MaskFormerSegmenter(seg, device=device, seed=cfg.seed)
    _load_weights(model, args, require_weights=True)
    metrics = _proposal_ar_eval(cfg, model_cfg, model, device, ds, args.mesh)
    print_csv_format(metrics, task="eval-proposal")
    print(json.dumps({"stage": "eval-proposal", "dataset": ds["name"], **metrics}))


# ---------------------------------------------------------------- stage 4


def _rank_num_objects(cfg, args, items) -> int:
    """The bank's size: ``--num-object-classes``, else the global
    vocabulary's (every shard must agree), else the largest class id + 1
    over every data rank's items."""
    if args.num_object_classes is not None:
        return args.num_object_classes
    from .data.datasets.imagenet import global_code_to_id

    try:
        return len(global_code_to_id(cfg.data.imagenet_root, cfg.data.vocab_map or None,
                                     cfg.data.manifest or None))
    except FileNotFoundError:
        top = max((it["class_id"] for it in items), default=0)
        if args.mesh.n_data > 1:
            from .engine.launch import all_gather_objects

            top = max(all_gather_objects(top, args.mesh.data_group))
        return 1 + top


def cmd_rank(args):
    """Stage 4: the cluster phase (per-object-class k-means of the proposals'
    decoder features -> ``rank_centroids.npz``), the save phase (the
    labelled part masks -> ``paths.part_masks_with_class``), and the match
    (``rank_mapping.npz``) and eval (mIoU) phases on the GT set. With
    ``--eval-dataset pascal | cityscapes`` every phase but save runs over
    that set, its GT parts in the proposals' role and its dataset-local
    object classes (``rank_centroids_<set>.npz``, ``rank_mapping_<set>.npz``)."""
    cfg = _setup(args)
    phases = args.phases.split(",")
    on_eval_set = args.eval_dataset != "part_imagenet"
    if on_eval_set and "save" in phases:
        raise SystemExit(f"--phases save not supported with --eval-dataset {args.eval_dataset}")
    import torch

    from . import resolve_device
    from .data.datasets.imagenet import load_imagenet_with_proposals
    from .data.loader import batch_iterator
    from .data.mappers import PartEvalMapper, PartRankingMapper
    from .data.pseudo_store import ShardWriter
    from .engine.launch import barrier, is_main_process
    from .evaluation.clustering import ClusteringModule
    from .models.meta_arch.part_ranking import (PartRankingConfig, RankingMode,
                                                make_cluster_fn, make_label_fn)
    from .models.segmenter import MaskFormerSegmenter
    from .utils import rle as rle_codec
    from .utils.bitpack import pack_bits, unpack_bits_np

    device = resolve_device(args.device)
    size = cfg.data.image_size
    ds = None
    if on_eval_set:
        ds = _load_eval_items(cfg, args)
        num_obj = args.num_object_classes or ds["num_obj_classes"]
        # the cluster phase's input: the GT part instances play the proposals' role
        items = _eval_share(_assign_eval_class_ids(cfg, ds, num_obj), args.mesh)
        eval_mapper = PartEvalMapper(image_size=size, capacity=cfg.data.mask_capacity,
                                     **ds["mapper_kwargs"])

        def mapper(item):
            ex = eval_mapper(item)
            if ex is None:
                return None
            return {"image": ex["image"], "object_mask": ex["object_mask"],
                    "part_masks": ex["gt_part_masks"], "part_valid": ex["gt_valid"],
                    "image_id": ex["image_id"], "class_id": ex["object_class"]}
    else:
        items = load_imagenet_with_proposals(
            _imagenet_items(cfg, args),
            cfg.paths.proposals if args.raw_proposals else cfg.paths.proposals_dcrf)
        num_obj = _rank_num_objects(cfg, args, items)
        mapper = PartRankingMapper(image_size=size, capacity=cfg.data.mask_capacity)
    logger.info("stage 4: %d items, %d object classes, phases=%s, dataset=%s", len(items),
                num_obj, phases, args.eval_dataset)

    seg = _segmenter_cfg(args.tiny, num_classes=1, num_queries=args.num_queries,
                         msda=_msda(args))
    rank_cfg = PartRankingConfig(segmenter=seg, num_clusters=args.num_clusters,
                                 test_topk=args.num_queries)
    model = MaskFormerSegmenter(seg, device=device, seed=cfg.seed)
    _load_weights(model, args, require_weights=True)
    suffix = f"_{args.eval_dataset}" if on_eval_set else ""
    centroid_path = os.path.join(cfg.checkpoint_dir, f"rank_centroids{suffix}.npz")
    mask_keys = ("part_masks", "object_mask")
    prepare = _unpack_train_batch(size, device, mask_keys=mask_keys)

    def batches():
        """(host batch, its images and masks on the device)."""
        for batch in batch_iterator(items, mapper, cfg.data.batch_size,
                                    num_workers=cfg.data.num_workers):
            wire = prepare(_pack_train_batch({k: batch[k] for k in ("image", *mask_keys)},
                                             mask_keys=mask_keys))
            yield batch, {"image": wire["image"], "masks": wire["part_masks"],
                          "mask_valid": torch.as_tensor(batch["part_valid"], device=device),
                          "object_mask": wire["object_mask"]}

    phase_stats = {}
    if "cluster" in phases:
        cluster_fn = make_cluster_fn(rank_cfg, model, device=device)
        clusterer = ClusteringModule(num_obj, seg.decoder.hidden_dim, args.num_clusters,
                                     device=device, **_gathered(args.mesh))
        timer = _StageTimer()
        for batch, dev_batch in batches():
            out = cluster_fn(dev_batch)
            bv = batch["batch_valid"]
            # only what the clustering reads crosses to the host
            clusterer.process({"feats": out["feats"].float().cpu().numpy()[bv],
                               "valid": out["valid"].cpu().numpy()[bv]},
                              batch["class_id"][bv])
            timer.batch(int(np.sum(bv)))
        stats = timer.stats()
        t0 = time.perf_counter()
        centroids = clusterer.evaluate()  # every data rank's reservoirs, merged
        t1 = time.perf_counter()
        if is_main_process():
            os.makedirs(cfg.checkpoint_dir, exist_ok=True)
            np.savez(centroid_path, centroids=centroids)
        barrier()
        counts = clusterer.counts()
        phase_stats["cluster"] = {
            **stats, "classes_seen": int((counts > 0).sum()), "features_held": int(counts.sum()),
            "kmeans_classes": int((counts > args.num_clusters).sum()),
            "kmeans_s": round(t1 - t0, 3), "bank_write_s": round(time.perf_counter() - t1, 3)}
        logger.info("stage 4 cluster: centroid bank %s saved", centroids.shape)

    if "save" in phases:
        # the bank goes up once; only the first --save-topk valid slots
        # (score order), bit-packed, come back
        cents = torch.as_tensor(np.load(centroid_path)["centroids"], device=device)
        label_fn = make_label_fn(rank_cfg, model, RankingMode.SAVE, device=device)
        save_cap = min(args.save_topk, args.num_queries)
        writer = ShardWriter(cfg.paths.part_masks_with_class, *_shard_id(args))
        n_saved, n_overflow, timer = 0, 0, _StageTimer()
        try:
            for batch, dev_batch in batches():
                out = label_fn({**dev_batch, "object_label": batch["class_id"],
                                "mask_labels": np.zeros(batch["part_valid"].shape, np.int32)},
                               cents)
                va = out["valid"]
                idx = torch.argsort((~va).to(torch.uint8), dim=1, stable=True)[:, :save_cap]
                rows = torch.arange(va.shape[0], device=va.device)[:, None]
                pm = unpack_bits_np(pack_bits(out["pred_masks"][rows, idx]).cpu().numpy(), size)
                sc = out["scores"][rows, idx].float().cpu().numpy()
                lb = out["pred_labels"][rows, idx].cpu().numpy()
                keep_va = va[rows, idx].cpu().numpy()
                bv = batch["batch_valid"]
                over = (va.sum(1) - save_cap).clamp(min=0).cpu().numpy()
                n_overflow += int(over[bv].sum())
                for b in range(pm.shape[0]):
                    keep = np.nonzero(keep_va[b])[0]
                    if not bv[b] or keep.size == 0:
                        continue
                    n_saved += int(writer.write({
                        "image_id": str(batch["image_id"][b]),
                        "part_masks": [rle_codec.encode(pm[b, i]) for i in keep],
                        "part_labels": [int(lb[b, i]) for i in keep],
                        "part_scores": [float(sc[b, i]) for i in keep],
                        "object_class": int(batch["class_id"][b]),
                    }))
                timer.batch(int(np.sum(bv)))
        finally:
            writer.close()
        if n_overflow:
            logger.warning("stage 4 save: %d valid parts beyond --save-topk %d were dropped; "
                           "raise --save-topk", n_overflow, save_cap)
        phase_stats["save"] = {"saved": n_saved, "overflow": n_overflow, **timer.stats()}
        logger.info("stage 4 save: %d records", n_saved)

    if "match" in phases or "eval" in phases:
        phase_stats.update(_rank_match_eval(cfg, args, rank_cfg, model, device, centroid_path,
                                            phases, num_obj, ds))
    print(json.dumps({"stage": "rank", "phases": phases, "dataset": args.eval_dataset,
                      **phase_stats}))


def _rank_match_eval(cfg, args, rank_cfg, model, device, centroid_path, phases,
                     num_obj, ds=None) -> dict:
    """Match (the majority-vote cluster -> GT part mapping, written to
    ``rank_mapping[_<set>].npz``) and eval (mIoU in the GT part-label space)
    on the GT set ``ds`` (``--eval-dataset`` when None). Returns each phase's
    timing, and the metrics under "eval"."""
    import torch

    from .data.loader import batch_iterator
    from .data.mappers import PartEvalMapper
    from .engine.launch import barrier, is_main_process
    from .engine.metrics import print_csv_format
    from .evaluation.miou import MIoUEvaluator, MIoUMatcher
    from .models.meta_arch.part_ranking import RankingMode, make_label_fn

    if ds is None:
        ds = _load_eval_items(cfg, args)
    items = _eval_share(_assign_eval_class_ids(cfg, ds, num_obj), args.mesh)
    n_gt_parts = ds["n_gt_parts"]
    suffix = "" if ds["name"] == "part_imagenet" else f"_{ds['name']}"
    mapping_path = os.path.join(cfg.checkpoint_dir, f"rank_mapping{suffix}.npz")
    mapper = PartEvalMapper(image_size=cfg.data.image_size, capacity=16, **ds["mapper_kwargs"])
    cents = torch.as_tensor(np.load(centroid_path)["centroids"], device=device)

    stats = {}

    def feed(metric, mode, mapping=None):
        label_fn = make_label_fn(rank_cfg, model, mode, device=device,
                                 num_label_space=n_gt_parts if mode == RankingMode.EVAL else None)
        timer = _StageTimer()
        for batch in batch_iterator(items, mapper, cfg.data.batch_size,
                                    num_workers=cfg.data.num_workers):
            out = _to_host(label_fn({
                "image": batch["image"], "object_label": batch["object_class"],
                "masks": batch["gt_part_masks"], "mask_labels": batch["gt_part_labels"],
                "mask_valid": batch["gt_valid"], "object_mask": batch["object_mask"]},
                cents, mapping))
            bv = batch["batch_valid"]
            metric.process({k: v[bv] for k, v in out.items()}, batch["gt_part_masks"][bv],
                           batch["gt_part_labels"][bv], batch["gt_valid"][bv],
                           batch["object_class"][bv])
            timer.batch(int(np.sum(bv)))
        stats[mode.value] = timer.stats()
        return metric.evaluate()

    mapping = None
    if "match" in phases:
        votes = feed(MIoUMatcher(pred_classes=rank_cfg.num_clusters, gt_classes=n_gt_parts,
                                 **_gathered(args.mesh)), RankingMode.MATCH)
        mapping = np.zeros((num_obj, rank_cfg.num_clusters), np.int32)
        for c, vote in votes.items():
            mapping[c] = vote[: rank_cfg.num_clusters]
        if is_main_process():
            os.makedirs(cfg.checkpoint_dir, exist_ok=True)
            np.savez(mapping_path, mapping=mapping)
        barrier()
        logger.info("stage 4 match: mapping for %d classes", len(votes))
    if "eval" in phases:
        if mapping is None:
            mapping = np.load(mapping_path)["mapping"]
        metrics = feed(MIoUEvaluator(gt_classes=n_gt_parts, **_gathered(args.mesh)),
                       RankingMode.EVAL, torch.as_tensor(mapping, device=device))
        print_csv_format(metrics, task="rank-eval")
        print(json.dumps({"stage": "rank-eval", **metrics}))
        stats["eval"].update(metrics)
    return stats


# ---------------------------------------------------------------- stage 5


def _distill_segmenter_cfg(args, freeze_trunk: bool = False):
    return _segmenter_cfg(args.tiny, num_classes=args.num_parts, num_queries=args.num_queries,
                          num_object_classes=args.num_object_classes,
                          num_parts=args.num_parts, msda=_msda(args),
                          freeze_trunk=freeze_trunk)


def cmd_train_distillation(args):
    cfg = _setup(args)
    import dataclasses

    from . import resolve_device
    from .data.datasets.imagenet import load_imagenet_with_segmentation
    from .data.loader import DataLoader
    from .data.mappers import PartDistillationTrainMapper
    from .engine.optim import OptimizerConfig
    from .engine.trainer import Trainer
    from .losses.criterion import CriterionConfig
    from .losses.matcher import MatcherConfig
    from .models.meta_arch.part_distillation import (PartDistillationConfig, make_loss_fn,
                                                     shard_part_head)
    from .models.segmenter import MaskFormerSegmenter

    device = resolve_device(args.device)
    base = _imagenet_items(cfg, args)
    items = load_imagenet_with_segmentation(base, cfg.paths.part_masks_with_class)
    logger.info("stage 5: %d train items in this process", len(items))
    _require_train_items(items, args.mesh)

    seg = _distill_segmenter_cfg(args, freeze_trunk=args.freeze_trunk)
    n_pts = 1024 if args.tiny else 12544
    model_cfg = PartDistillationConfig(
        segmenter=seg, criterion=CriterionConfig(num_classes=args.num_parts, num_points=n_pts,
                                                 matcher=MatcherConfig(num_points=n_pts)),
        num_parts=args.num_parts)
    model = MaskFormerSegmenter(seg, device=device, seed=cfg.seed)
    # a warm start, e.g. from the stage-3 proposal model: the part head
    # matches no stage-3 tensor by name and keeps its initialisation
    _load_weights(model, args)
    size = cfg.data.image_size
    mesh = args.mesh
    trainer = Trainer(
        make_loss_fn(model_cfg, model, device=device, group=mesh.data_group), model,
        OptimizerConfig(freeze_keys=("backbone", "pixel_decoder") if args.freeze_trunk else ()),
        device=device, seed=cfg.seed,
        checkpoint_dir=os.path.join(cfg.checkpoint_dir, "part_distillation"),
        batch_prepare=_unpack_train_batch(size, device), mesh=mesh,
        # n_model_shards > 1: the head's hidden slices (and their moments)
        # over the model group, gathered whole into the checkpoints
        sharded=shard_part_head(model, mesh))
    trainer.resume_or_load()

    mapper = PartDistillationTrainMapper(image_size=size, capacity=cfg.data.mask_capacity,
                                         seed=cfg.seed)
    loader = DataLoader(items, mapper, cfg.data.batch_size, shuffle=True, seed=cfg.seed,
                        epochs=None, num_workers=cfg.data.num_workers, drop_last=True)
    eval_fn = None
    if cfg.eval_every > 0:
        ds = _load_eval_items(cfg, args)
        infer_cfg = dataclasses.replace(
            model_cfg, test_topk=min(model_cfg.test_topk, args.num_queries * args.num_parts))
        eval_fn = lambda: _distill_match_eval(  # noqa: E731
            cfg, args, infer_cfg, model, device, ("match", "eval"), ds)
    stats = _train_loop(cfg, trainer, loader, "train-distillation", eval_fn=eval_fn,
                        vis_fn=_vis_fn(cfg, "train-distillation", model, device,
                                       needs_object_class=True))
    print(json.dumps({"stage": "train-distillation", **stats}))


def _distill_setup(cfg, args, device):
    """Model config and weights for the stage-5 save and eval commands (the
    head split over the model group when n_model_shards > 1)."""
    from .models.meta_arch.part_distillation import PartDistillationConfig, shard_part_head
    from .models.segmenter import MaskFormerSegmenter

    seg = _distill_segmenter_cfg(args)
    model_cfg = PartDistillationConfig(
        segmenter=seg, num_parts=args.num_parts,
        test_topk=min(args.topk, args.num_queries * args.num_parts))
    model = MaskFormerSegmenter(seg, device=device, seed=cfg.seed)
    _load_weights(model, args, require_weights=True)
    shard_part_head(model, args.mesh)
    return model_cfg, model


def _to_host(out) -> dict:
    return {k: (v.float() if v.is_floating_point() else v).cpu().numpy() for k, v in out.items()}


def cmd_distill_save(args):
    """Stage-5 save pass: the trained model over the stage-4 set, its part
    predictions written to ``paths.predictions``
    (part_distillation_model.py:290-311). The ranks of a model group run
    the same images; the first of them writes the group's shard."""
    cfg = _setup(args)
    from . import resolve_device
    from .data.datasets.imagenet import load_imagenet_with_segmentation
    from .data.loader import batch_iterator
    from .data.mappers import PartDistillationSaveMapper
    from .data.pseudo_store import ShardWriter
    from .engine.launch import all_gather_objects
    from .models.meta_arch.part_distillation import make_inference_fn
    from .utils import rle as rle_codec

    device = resolve_device(args.device)
    mesh = args.mesh
    base = _imagenet_items(cfg, args)
    items = load_imagenet_with_segmentation(base, cfg.paths.part_masks_with_class)
    writer = ShardWriter(cfg.paths.predictions, *_shard_id(args)) \
        if mesh.model_index == 0 else None
    written = set(writer.written_ids) if writer is not None else set()
    if mesh.n_model > 1:
        written = all_gather_objects(written, mesh.model_group)[0]
    items = [it for it in items if it["image_id"] not in written]
    logger.info("stage 5 save: %d images to process", len(items))

    model_cfg, model = _distill_setup(cfg, args, device)
    infer_fn = make_inference_fn(model_cfg, model, mode="save", device=device)
    mapper = PartDistillationSaveMapper(image_size=cfg.data.image_size,
                                        capacity=cfg.data.mask_capacity)
    n_saved, n_batches, timer = 0, 0, _StageTimer()
    try:
        for batch in batch_iterator(items, mapper, cfg.data.batch_size,
                                    num_workers=cfg.data.num_workers):
            out = _to_host(infer_fn({
                # the JAX CLI's wire format sends the image as uint8
                "image": np.clip(batch["image"], 0, 255).astype(np.uint8),
                "gt_object_class": batch["gt_object_class"],
                "part_masks": batch["part_masks"],
                "part_labels": batch["part_labels"],
                "part_valid": batch["part_valid"],
                "object_masks": batch["object_mask"][:, None],
                "object_valid": np.ones((batch["object_mask"].shape[0], 1), bool),
            }))
            n_batches += 1
            timer.batch(int(np.sum(batch["batch_valid"])))
            if writer is None:
                continue
            pm, sc, lb, va = (out[k] for k in ("pred_masks", "scores", "pred_labels", "valid"))
            for b in range(pm.shape[0]):
                if not batch["batch_valid"][b]:
                    continue
                keep = np.nonzero(va[b])[0]
                if keep.size == 0:
                    continue
                n_saved += int(writer.write({
                    "image_id": str(batch["image_id"][b]),
                    "part_masks": [rle_codec.encode(pm[b, i]) for i in keep],
                    "part_labels": [int(lb[b, i]) for i in keep],
                    "part_scores": [float(sc[b, i]) for i in keep],
                    "object_class": int(batch["gt_object_class"][b]),
                }))
            if n_batches % 20 == 0:
                writer.flush()
    finally:
        if writer is not None:
            writer.close()
    print(json.dumps({"stage": "distill-save", "saved": n_saved, **timer.stats()}))


def _distill_match_eval(cfg, args, model_cfg, model, device, phases, ds=None):
    """Stage-5 match (the majority-vote cluster -> GT part mapping, written
    to ``distill_mapping[_<set>].npz``) and eval (mIoU in the GT part-label space)
    on a GT part dataset (part_distillation_model.py:470-472), this data
    rank's share of it, gathered over the data ranks. Leaves the model in
    the mode it found it in."""
    from .data.loader import batch_iterator
    from .data.mappers import PartEvalMapper
    from .engine.launch import barrier, is_main_process
    from .evaluation.miou import MIoUEvaluator, MIoUMatcher
    from .models.meta_arch.part_distillation import make_inference_fn

    if ds is None:
        ds = _load_eval_items(cfg, args)
    num_obj = args.num_object_classes
    items = _eval_share(_assign_eval_class_ids(cfg, ds, num_obj), args.mesh)
    n_gt_parts = ds["n_gt_parts"]
    suffix = "" if ds["name"] == "part_imagenet" else f"_{ds['name']}"
    mapping_path = os.path.join(cfg.checkpoint_dir, f"distill_mapping{suffix}.npz")
    mapper = PartEvalMapper(image_size=cfg.data.image_size, capacity=16,
                            **ds["mapper_kwargs"])
    training = model.training

    def run(mode, mapping=None):
        infer_fn = make_inference_fn(model_cfg, model, mode=mode, device=device,
                                     num_label_space=n_gt_parts if mode == "eval" else None)
        for batch in batch_iterator(items, mapper, cfg.data.batch_size,
                                    num_workers=cfg.data.num_workers):
            out = infer_fn({
                "image": batch["image"],
                "gt_object_class": batch["object_class"],
                "part_masks": batch["gt_part_masks"],
                "part_labels": batch["gt_part_labels"],
                "part_valid": batch["gt_valid"],
                "object_masks": batch["object_mask"][:, None],
                "object_valid": np.ones((batch["object_mask"].shape[0], 1), bool),
            }, mapping)
            yield batch, _to_host(out)

    def feed(metric, mode, mapping=None):
        for batch, out in run(mode, mapping):
            bv = batch["batch_valid"]
            metric.process({k: v[bv] for k, v in out.items()}, batch["gt_part_masks"][bv],
                           batch["gt_part_labels"][bv], batch["gt_valid"][bv],
                           batch["object_class"][bv])
        return metric.evaluate()

    try:
        mapping = None
        if "match" in phases:
            votes = feed(MIoUMatcher(pred_classes=model_cfg.num_parts, gt_classes=n_gt_parts,
                                     **_gathered(args.mesh)), "save")
            mapping = np.zeros((num_obj, model_cfg.num_parts), np.int32)
            for c, vote in votes.items():
                mapping[c] = vote[: model_cfg.num_parts]
            if is_main_process():
                os.makedirs(cfg.checkpoint_dir, exist_ok=True)
                np.savez(mapping_path, mapping=mapping)
            barrier()
            logger.info("stage 5 match: mapping for %d classes", len(votes))
        if "eval" not in phases:
            return None
        if mapping is None:
            mapping = np.load(mapping_path)["mapping"]
        return feed(MIoUEvaluator(gt_classes=n_gt_parts, **_gathered(args.mesh)), "eval",
                    mapping)
    finally:
        model.train(training)


def cmd_distill_eval(args):
    """Stage-5 mIoU evaluation (match and eval phases)."""
    cfg = _setup(args)
    from . import resolve_device

    device = resolve_device(args.device)
    phases = args.phases.split(",")
    ds = _load_eval_items(cfg, args)
    model_cfg, model = _distill_setup(cfg, args, device)
    metrics = _distill_match_eval(cfg, args, model_cfg, model, device, phases, ds)
    out = {"stage": "distill-eval", "dataset": ds["name"], "phases": phases}
    if metrics is not None:
        from .engine.metrics import print_csv_format

        print_csv_format(metrics, task="distill-eval")
        out.update(metrics)
    print(json.dumps(out))


# ---------------------------------------------------------------- ablation


def _supervised_setup(cfg, args, device, require_weights: bool = False):
    """The supervised commands' items, model config and model with its
    weights. ``--eval-dataset`` is the GT part set trained and evaluated on;
    ``--label-percentage`` keeps that share of its items, chosen by
    ``RandomState(1234).permutation`` as the JAX CLI chooses them. The
    default configuration trains the whole trunk, bf16 at full size; the
    v1 heads (``--pixel-decoder``, ``--decoder``) compute in f32."""
    import dataclasses

    from .losses.criterion import CriterionConfig
    from .losses.matcher import MatcherConfig
    from .models.fpn import FPNPixelDecoderConfig
    from .models.maskformer_decoder import StandardDecoderConfig
    from .models.meta_arch.supervised import SupervisedModelConfig
    from .models.segmenter import MaskFormerSegmenter

    ds = _load_eval_items(cfg, args)
    items = ds["items"]
    if args.label_percentage is not None and args.label_percentage < 100.0:
        n_keep = max(1, int(round(len(items) * args.label_percentage / 100.0)))
        keep = np.random.RandomState(1234).permutation(len(items))[:n_keep]
        items = [items[i] for i in sorted(keep)]
    n_cls = args.num_part_classes if ds["name"] == "part_imagenet" else ds["n_gt_parts"]
    train_classes = 1 if args.class_agnostic else n_cls
    seg = _segmenter_cfg(args.tiny, num_classes=train_classes, num_queries=args.num_queries,
                         msda=_msda(args), backbone=args.backbone,
                         image_size=cfg.data.image_size)
    if args.pixel_decoder != "msdeform" or args.decoder != "multi_scale":
        if args.tiny:
            fpn = FPNPixelDecoderConfig(conv_dim=32, mask_dim=32, transformer_enc_layers=1,
                                        n_heads=4, transformer_ffn_dim=64)
            std = StandardDecoderConfig(num_classes=train_classes, hidden_dim=32,
                                        num_queries=args.num_queries, num_heads=4,
                                        dim_feedforward=64, dec_layers=2, mask_dim=32)
        else:
            fpn = FPNPixelDecoderConfig()
            std = StandardDecoderConfig(num_classes=train_classes, num_queries=args.num_queries)
        seg = dataclasses.replace(seg, pixel_decoder_type=args.pixel_decoder, fpn=fpn,
                                  decoder_type=args.decoder, standard_decoder=std)
    n_pts = 1024 if args.tiny else 12544
    model_cfg = SupervisedModelConfig(
        segmenter=seg,
        criterion=CriterionConfig(num_classes=train_classes, num_points=n_pts,
                                  importance_sample_ratio=0.75,
                                  matcher=MatcherConfig(num_points=n_pts)),
        num_part_classes=n_cls, class_agnostic_learning=args.class_agnostic,
        class_agnostic_inference=args.class_agnostic, test_topk=args.num_queries)
    model = MaskFormerSegmenter(seg, device=device, seed=cfg.seed)
    _load_weights(model, args, require_weights=require_weights, exact_shapes=True)
    return items, model_cfg, model, ds


def _v1_f32(args, device):
    """Both TF32 flags off while an f32 v1 head computes (the backward too)."""
    import contextlib

    from .utils.precision import full_f32

    v1 = args.pixel_decoder != "msdeform" or args.decoder != "multi_scale"
    return full_f32(device) if v1 else contextlib.nullcontext()


def _supervised_eval(cfg, model_cfg, model, device, ds, mesh, items=None):
    """(the supervised model's mIoU over one global confusion matrix on the
    GT set, its timing): this data rank's share of ``items`` (all of ``ds``
    by default), gathered over the data ranks. Leaves the model in the mode
    it found it in."""
    from .data.loader import batch_iterator
    from .data.mappers import PartEvalMapper
    from .evaluation.miou import SupervisedMIoUEvaluator
    from .models.meta_arch.supervised import make_inference_fn

    training = model.training
    mapper = PartEvalMapper(image_size=cfg.data.image_size, capacity=16, **ds["mapper_kwargs"])
    infer_fn = make_inference_fn(model_cfg, model, device=device)
    evaluator = SupervisedMIoUEvaluator(gt_classes=model_cfg.num_part_classes, **_gathered(mesh))
    timer = _StageTimer()
    for batch in batch_iterator(_eval_share(ds["items"] if items is None else items, mesh),
                                mapper, cfg.data.batch_size, num_workers=cfg.data.num_workers):
        out = _to_host(infer_fn({"image": batch["image"], "object_mask": batch["object_mask"]}))
        bv = batch["batch_valid"]
        evaluator.process({k: v[bv] for k, v in out.items()}, batch["gt_part_masks"][bv],
                          batch["gt_part_labels"][bv], batch["gt_valid"][bv],
                          batch["object_class"][bv])
        timer.batch(int(np.sum(bv)))
    model.train(training)
    return evaluator.evaluate(), timer.stats()


def cmd_train_supervised(args):
    """The supervised / fewshot ablation: train on the GT parts of
    ``--eval-dataset`` (``--label-percentage``: the fewshot subset), into
    ``<checkpoint_dir>/supervised``."""
    cfg = _setup(args)
    from . import resolve_device
    from .data.loader import DataLoader
    from .data.mappers import PartEvalMapper
    from .engine.optim import OptimizerConfig
    from .engine.trainer import Trainer
    from .models.meta_arch.supervised import make_loss_fn

    device = resolve_device(args.device)
    items, model_cfg, model, ds = _supervised_setup(cfg, args, device)
    items = _eval_share(items, args.mesh)
    logger.info("supervised: %d train items in this process on %s (label %% = %s)",
                len(items), ds["name"], args.label_percentage)
    _require_train_items(items, args.mesh)
    size = cfg.data.image_size
    gt_mapper = PartEvalMapper(image_size=size, capacity=cfg.data.mask_capacity,
                               **ds["mapper_kwargs"])

    def mapper(item):
        ex = gt_mapper(item)
        if ex is None:
            return None
        return {"image": ex["image"], "masks": ex["gt_part_masks"], "labels": ex["gt_part_labels"],
                "valid": ex["gt_valid"], "image_id": ex["image_id"]}

    trainer = Trainer(
        make_loss_fn(model_cfg, model, device=device, group=args.mesh.data_group), model,
        OptimizerConfig(), device=device, seed=cfg.seed,
        checkpoint_dir=os.path.join(cfg.checkpoint_dir, "supervised"),
        batch_prepare=_unpack_train_batch(size, device), mesh=args.mesh)
    try:
        trainer.resume_or_load()
    except ValueError as e:  # a checkpoint of another head width
        raise SystemExit(str(e)) from e
    loader = DataLoader(items, mapper, cfg.data.batch_size, shuffle=True, seed=cfg.seed,
                        epochs=None, num_workers=cfg.data.num_workers, drop_last=True)
    eval_fn = None
    if cfg.eval_every > 0:
        eval_fn = lambda: _supervised_eval(cfg, model_cfg, model, device, ds,  # noqa: E731
                                           args.mesh)[0]
    with _v1_f32(args, device):
        stats = _train_loop(cfg, trainer, loader, "train-supervised", eval_fn=eval_fn,
                            vis_fn=_vis_fn(cfg, "train-supervised", model, device))
    print(json.dumps({"stage": "train-supervised", **stats}))


def cmd_eval_supervised(args):
    """The supervised model's mIoU on ``--eval-dataset`` (the fewshot subset
    with ``--label-percentage``)."""
    cfg = _setup(args)
    from . import resolve_device
    from .engine.metrics import print_csv_format

    device = resolve_device(args.device)
    items, model_cfg, model, ds = _supervised_setup(cfg, args, device, require_weights=True)
    with _v1_f32(args, device):
        metrics, timing = _supervised_eval(cfg, model_cfg, model, device, ds, args.mesh,
                                           items=items)
    print_csv_format(metrics, task="eval-supervised")
    print(json.dumps({"stage": "eval-supervised", "dataset": ds["name"], **metrics, **timing}))


# ---------------------------------------------------------------- doctor


_BACKEND_PROBE = (
    "import json, torch\n"
    "ok = torch.cuda.is_available()\n"
    "print(json.dumps({'cuda': ok, 'devices': torch.cuda.device_count() if ok else 0,\n"
    "                  'name': torch.cuda.get_device_name(0) if ok else None}))\n")


def _probe_backend(device, timeout: int) -> dict:
    """torch's view of the card from a fresh process, with a time limit (a
    wedged driver can hang CUDA's initialisation): ok on ``cpu`` when torch
    imports, on ``cuda`` when a device is there."""
    import subprocess
    import sys

    import torch

    try:
        r = subprocess.run([sys.executable, "-c", _BACKEND_PROBE], capture_output=True,
                           text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"ok": False, "error": f"torch's CUDA initialisation hung > {timeout}s: the "
                                      "driver or the card is wedged"}
    if r.returncode != 0:
        tail = (r.stderr or r.stdout).strip().splitlines()[-1:]
        return {"ok": False, "error": (tail or ["?"])[0][:300]}
    seen = json.loads(r.stdout.strip().splitlines()[-1])
    if torch.device(device).type == "cpu":
        return {"ok": True, "platform": "cpu", "devices": 1, "cuda_available": seen["cuda"]}
    if not seen["cuda"]:
        return {"ok": False, "platform": "cuda", "devices": 0,
                "error": "torch.cuda.is_available() is False: no CUDA device or driver "
                         "(--device cpu runs the plain versions)"}
    return {"ok": True, "platform": "cuda", "devices": seen["devices"], "name": seen["name"]}


def _diagnose(fn) -> dict:
    """``{"ok": True, **fn()}``, or the failure's message: a health check
    reports what breaks and goes on to the next item."""
    try:
        return {"ok": True, **fn()}
    except Exception as e:  # noqa: BLE001 - diagnostic surface
        return {"ok": False, "error": f"{type(e).__name__}: {str(e)[-300:]}"}


def cmd_doctor(args):
    """Environment health check: the backend (probed in a subprocess with
    ``--backend-timeout``), torch's and CUDA's versions, the store root,
    the kernel build directory, the kernel library (built and loaded on
    ``cuda``; no kernel is needed on ``cpu``) and the host codec. Prints the
    report; exits 2 when anything is not ok."""
    cfg = _setup(args)
    import torch

    from .utils import native_lib

    report = {"stage": "doctor", "backend": _probe_backend(args.device, args.backend_timeout),
              "torch": {"version": torch.__version__, "cuda": torch.version.cuda}}
    root = cfg.paths.root
    try:
        os.makedirs(root, exist_ok=True)
        probe = os.path.join(root, ".doctor_probe")
        with open(probe, "w") as f:
            f.write("ok")
        os.remove(probe)
        report["pseudo_label_root"] = {"ok": True, "path": root}
    except OSError as e:
        report["pseudo_label_root"] = {"ok": False, "path": root, "error": str(e)[:200]}

    def kernels():
        native_lib.load_library()
        return {"library": native_lib.build_library().name}

    def host_codec():
        native_lib.load_host_library()
        return {"library": native_lib.build_host_library().name}

    if torch.device(args.device).type == "cuda":
        report["kernels"] = _diagnose(kernels)
    else:
        report["kernels"] = {"ok": True, "needed": False,
                             "note": "--device cpu runs the plain versions; no kernel is built"}
    report["host_codec"] = _diagnose(host_codec)
    build = native_lib.BUILD_DIR  # after the builds above: what they left there
    report["kernel_build_dir"] = {"path": str(build), "exists": build.is_dir(),
                                  "entries": sorted(os.listdir(build)) if build.is_dir() else []}
    ok = all(v.get("ok", True) for v in report.values() if isinstance(v, dict) and "ok" in v)
    report["ok"] = ok
    print(json.dumps(report, indent=2))
    if not ok:
        raise SystemExit(2)


# ---------------------------------------------------------------- profile


def cmd_profile(args):
    """Trace ``--steps`` stage-3 train steps on a synthetic batch and print
    the device time a step by scope, the backward's by the forward part it
    differentiates and the device's idle time by span
    (``utils/profiling.py``): the trunk unfrozen, 12544 grid points at full
    size (1024 with ``--tiny``), the weights from ``--torch-params`` /
    ``--trainer-checkpoint`` or the seeded initialisation; ``--backbone
    vitdet-l`` (with ``--set data.image_size=1024``) traces ViTDet-L's trunk. The
    Chrome trace goes to ``--output`` (default ``<checkpoint_dir>/profile``)."""
    cfg = _setup(args)
    from . import resolve_device
    from .engine.launch import is_main_process, process_index
    from .engine.optim import OptimizerConfig
    from .engine.trainer import Trainer
    from .losses.criterion import CriterionConfig
    from .losses.matcher import MatcherConfig
    from .models.meta_arch.proposal import ProposalModelConfig, make_loss_fn
    from .models.segmenter import MaskFormerSegmenter
    from .utils.profiling import summarize_trace, trace_steps

    device = resolve_device(args.device)
    seg = _segmenter_cfg(args.tiny, msda=_msda(args), num_classes=1,
                         num_queries=args.num_queries, backbone=args.backbone,
                         image_size=cfg.data.image_size)
    n_pts = 1024 if args.tiny else 12544
    model_cfg = ProposalModelConfig(
        segmenter=seg, criterion=CriterionConfig(num_classes=1, num_points=n_pts,
                                                 importance_sample_ratio=0.0,
                                                 matcher=MatcherConfig(num_points=n_pts)))
    model = MaskFormerSegmenter(seg, device=device, seed=cfg.seed)
    _load_weights(model, args)
    size = cfg.data.image_size
    b, t = cfg.data.batch_size, cfg.data.mask_capacity
    rng = np.random.RandomState(cfg.seed)
    batch = _pack_train_batch({
        "image": rng.randint(0, 255, (b, size, size, 3)).astype(np.float32),
        "masks": rng.rand(b, t, size, size) < 0.2,
        "valid": np.tile(np.arange(t) < 4, (b, 1)),
    })
    trainer = Trainer(make_loss_fn(model_cfg, model, device=device, group=args.mesh.data_group),
                      model, OptimizerConfig(), device=device, seed=cfg.seed,
                      batch_prepare=_unpack_train_batch(size, device), mesh=args.mesh)

    out_dir = args.output or os.path.join(cfg.checkpoint_dir, "profile")
    if not is_main_process():
        out_dir = os.path.join(out_dir, f"rank{process_index()}")
    trace_steps(lambda: trainer.train_step(batch), out_dir, steps=args.steps)
    summary, detail = summarize_trace(out_dir, steps=args.steps, return_detail=True)
    top = dict(list(summary.items())[: args.top])
    if not is_main_process():
        return
    tables = {"backward_by_scope": detail["backward_by_scope"],
              "idle_by_span": detail["idle_by_span"]}
    for scope, ms in top.items():
        print(f"{ms:9.2f} ms/step  {scope}")
    for name, table in tables.items():
        for scope, ms in table.items():
            print(f"{ms:9.2f} ms/step  {name}: {scope}")
    print(json.dumps({"stage": "profile", "trace_dir": out_dir,
                      "total_ms_per_step": round(sum(summary.values()), 2),
                      "top": {k: round(v, 2) for k, v in top.items()},
                      **{name: {k: round(v, 3) for k, v in table.items()}
                         for name, table in tables.items()}}))


# ---------------------------------------------------------------- visualize


def cmd_visualize(args):
    """Collage of a store's part masks over their images (the reference's
    make_visualization.py): the first ``--max-images`` records of the store
    whose image the ImageNet root holds, resized to ``data.image_size``."""
    cfg = _setup(args)
    from .data.pseudo_store import PseudoLabelStore
    from .data.transforms import load_image, resize_image, resize_mask
    from .utils import rle as rle_codec
    from .utils.visualize import make_collage, overlay_masks, save_image

    store = PseudoLabelStore(args.store or cfg.paths.proposals_dcrf)
    items = {it["image_id"]: it for it in _imagenet_items(cfg, args)}
    size = cfg.data.image_size
    panels = []
    for record in store:
        item = items.get(record["image_id"])
        if item is None:
            continue
        image = load_image(item["file_name"])
        if image is None:
            continue
        image = resize_image(image, (size, size))
        masks = np.stack([resize_mask(rle_codec.decode(r), (size, size))
                          for r in record["part_masks"]])
        panels.append(overlay_masks(image, masks, labels=record.get("part_labels")))
        if len(panels) >= args.max_images:
            break
    if not panels:
        raise SystemExit("no overlapping images between store and dataset")
    save_image(args.output, make_collage(panels, cols=args.cols))
    print(json.dumps({"stage": "visualize", "panels": len(panels), "output": args.output}))


# ---------------------------------------------------------------- main


def _add_common(p):
    p.add_argument("--config", default=None, help="yaml config (with _BASE_)")
    p.add_argument("--set", nargs="*", default=[],
                   help="dotted overrides: data.batch_size=4 ...")
    p.add_argument("--shard", type=int, default=None)
    p.add_argument("--num-shards", type=int, default=None)
    p.add_argument("--tiny", action="store_true",
                   help="tiny f32 model (smoke tests; --device cpu only)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    p.add_argument("--params", default=None,
                   help="an Orbax params checkpoint: refused (needs JAX); use --torch-params")
    p.add_argument("--trainer-checkpoint", default=None,
                   help="a port Trainer checkpoint dir (loads the newest step's weights)")
    p.add_argument("--torch-params", default=None,
                   help="a torch state_dict with detectron2/Mask2Former keys")
    p.add_argument("--allow-random-init", action="store_true",
                   help="let eval commands run with freshly-initialized weights "
                        "(smoke tests only)")
    p.add_argument("--msda-mode", default=None,
                   choices=["onehot_mxu", "take", "banded", "pallas_folded"],
                   help="deformable-attention sampling (default: banded at full size, dense "
                        "with --tiny); onehot_mxu, take and pallas_folded are the one "
                        "dense function here")
    p.add_argument("--msda-band-radius", type=int, default=None,
                   help="tap radius in level pixels for --msda-mode banded (default 6; "
                        "4 at full size)")


def _add_backbone(p):
    p.add_argument("--backbone", default="swin-l", choices=["swin-l", "vitdet-l"],
                   help="the segmenter's backbone: Swin-L, or ViTDet-L (a plain ViT-L/16 "
                        "with window and global attention and a simple feature pyramid, "
                        "published at --set data.image_size=1024)")


def _add_eval_dataset(p):
    p.add_argument("--eval-dataset", default="part_imagenet",
                   choices=["part_imagenet", "pascal", "cityscapes"],
                   help="GT part dataset for evaluation (and the supervised commands' "
                        "training)")
    p.add_argument("--num-gt-parts", type=int, default=40,
                   help="GT part-label space (part_imagenet only)")


def build_parser():
    parser = argparse.ArgumentParser("partdistillation_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("label", help="stage 1: object labels from precomputed detections")
    _add_common(p)
    p.add_argument("--detections", required=True, help="store dir of precomputed detections")
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--score-threshold", type=float, default=0.0)
    p.add_argument("--no-class-match", action="store_true")
    p.set_defaults(fn=cmd_label)

    p = sub.add_parser("detect", help="stage 1 from pixels: segmenter proposals + CLIP")
    _add_common(p)
    p.add_argument("--num-queries", type=int, default=200)
    p.add_argument("--proposals", type=int, default=100,
                   help="mask proposals per image before class filtering")
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--score-threshold", type=float, default=0.0)
    p.add_argument("--clip-model", default=None,
                   help="local CLIP checkpoint dir (transformers format)")
    p.add_argument("--clip-backend", choices=("device", "tpu", "torch"), default="device",
                   help="region embeddings: the port's CLIP towers on --device ('tpu' is an "
                        "alias, for the JAX CLI's command lines) or transformers' CLIPModel "
                        "on the host ('torch')")
    p.add_argument("--no-class-match", action="store_true")
    p.set_defaults(fn=cmd_detect)

    p = sub.add_parser("eval-detect", help="stage-1 detection AR vs object ground truth")
    _add_common(p)
    _add_eval_dataset(p)
    p.add_argument("--num-queries", type=int, default=200)
    p.add_argument("--topk", type=int, default=100)
    p.set_defaults(fn=cmd_eval_detect)

    p = sub.add_parser("propose", help="stage 2: pixel grouping -> paths.proposals")
    _add_common(p)
    p.add_argument("--num-clusters", type=int, default=4)
    p.set_defaults(fn=cmd_propose)

    p = sub.add_parser("eval-pixel-grouping", help="stage-2 AR eval vs GT parts")
    _add_common(p)
    p.add_argument("--num-clusters", type=int, default=4)
    p.set_defaults(fn=cmd_eval_pixel_grouping)

    p = sub.add_parser("dcrf", help="stage 2b: dense-CRF smoothing -> paths.proposals_dcrf")
    _add_common(p)
    p.add_argument("--gt-prob", type=float, default=0.7)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--bilateral-sxy", type=float, default=20.0)
    p.add_argument("--bilateral-stride", type=int, default=None,
                   help="window-grid cell size in px (default round(sxy / 5), 4 at sxy 20; "
                        "smaller = finer and slower)")
    p.add_argument("--watch", action="store_true",
                   help="run alongside stage 2: rescan for new proposals until every "
                        "propose shard marks completion")
    p.add_argument("--watch-interval", type=float, default=10.0,
                   help="seconds between --watch rescans")
    p.set_defaults(fn=cmd_dcrf)

    p = sub.add_parser("train-proposal", help="stage 3: proposal learning")
    _add_common(p)
    _add_eval_dataset(p)
    p.add_argument("--num-queries", type=int, default=200)
    p.add_argument("--freeze-trunk", action="store_true", default=True)
    p.add_argument("--no-freeze-trunk", dest="freeze_trunk", action="store_false")
    p.add_argument("--raw-proposals", action="store_true",
                   help="train on raw stage-2 output (skip dCRF)")
    p.set_defaults(fn=cmd_train_proposal)

    p = sub.add_parser("eval-proposal", help="stage-3 AR eval of the trained ProposalModel")
    _add_common(p)
    _add_eval_dataset(p)
    p.add_argument("--num-queries", type=int, default=200)
    p.add_argument("--topk", type=int, default=200)
    p.add_argument("--no-unique-assignment", action="store_true")
    p.set_defaults(fn=cmd_eval_proposal)

    p = sub.add_parser("rank", help="stage 4: part ranking (cluster, save, match, eval)")
    _add_common(p)
    _add_eval_dataset(p)
    p.add_argument("--phases", default="cluster,save")
    p.add_argument("--num-clusters", type=int, default=8)
    p.add_argument("--num-queries", type=int, default=200)
    p.add_argument("--num-object-classes", type=int, default=None,
                   help="the bank's classes (default: the global vocabulary's size)")
    p.add_argument("--raw-proposals", action="store_true",
                   help="rank the raw stage-2 proposals (skip dCRF)")
    p.add_argument("--save-topk", type=int, default=32,
                   help="save phase: the most valid parts an image saves (compacted on the "
                        "device; the overflow is counted and logged)")
    p.set_defaults(fn=cmd_rank)

    def add_part_head(p):
        p.add_argument("--num-queries", type=int, default=200)
        p.add_argument("--num-parts", type=int, default=8)
        p.add_argument("--num-object-classes", type=int, default=22000)

    p = sub.add_parser("train-distillation", help="stage 5: self-training")
    _add_common(p)
    _add_eval_dataset(p)
    add_part_head(p)
    p.add_argument("--freeze-trunk", action="store_true", default=True)
    p.add_argument("--no-freeze-trunk", dest="freeze_trunk", action="store_false")
    p.set_defaults(fn=cmd_train_distillation)

    p = sub.add_parser("distill-save", help="stage-5 save pass -> paths.predictions")
    _add_common(p)
    add_part_head(p)
    p.add_argument("--topk", type=int, default=200)
    p.set_defaults(fn=cmd_distill_save)

    p = sub.add_parser("distill-eval", help="stage-5 mIoU eval (match + eval phases)")
    _add_common(p)
    _add_eval_dataset(p)
    p.add_argument("--phases", default="match,eval")
    add_part_head(p)
    p.add_argument("--topk", type=int, default=200)
    p.set_defaults(fn=cmd_distill_eval)

    for name, fn in (("train-supervised", cmd_train_supervised),
                     ("eval-supervised", cmd_eval_supervised)):
        p = sub.add_parser(name, help="supervised / fewshot ablation")
        _add_common(p)
        _add_eval_dataset(p)
        p.add_argument("--num-queries", type=int, default=200)
        p.add_argument("--num-part-classes", type=int, default=40)
        p.add_argument("--class-agnostic", action="store_true")
        p.add_argument("--label-percentage", type=float, default=None,
                       help="fewshot subset %% (seed 1234)")
        p.add_argument("--pixel-decoder", default="msdeform",
                       choices=["msdeform", "fpn", "transformer_fpn"])
        p.add_argument("--decoder", default="multi_scale", choices=["multi_scale", "standard"])
        _add_backbone(p)
        p.set_defaults(fn=fn)

    p = sub.add_parser("doctor", help="environment health check (backend, paths, kernel "
                                      "build, host codec)")
    _add_common(p)
    p.add_argument("--backend-timeout", type=int, default=120,
                   help="seconds before declaring the backend wedged")
    p.set_defaults(fn=cmd_doctor)

    p = sub.add_parser("profile", help="trace N train steps, print the breakdown by scope")
    _add_common(p)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--num-queries", type=int, default=200)
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--output", default=None, help="trace dir (default: ckpt/profile)")
    _add_backbone(p)
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("visualize", help="collage of pseudo-label overlays")
    _add_common(p)
    p.add_argument("--store", default=None, help="store dir (default: dCRF proposals)")
    p.add_argument("--output", default="collage.png")
    p.add_argument("--max-images", type=int, default=16)
    p.add_argument("--cols", type=int, default=4)
    p.set_defaults(fn=cmd_visualize)
    return parser


def main(argv=None):
    """Parse ``argv`` and run the subcommand; under ``torchrun`` inside the
    process group, which it creates and destroys unless the caller made it."""
    from .engine.launch import initialize, teardown

    args = build_parser().parse_args(argv)
    _refuse_early(args)
    owned = initialize(args.device)
    try:
        args.fn(args)
    finally:
        if owned:
            teardown()


if __name__ == "__main__":
    main()
