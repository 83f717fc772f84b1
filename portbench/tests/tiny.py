"""Tiny versions of the benchmark's configurations and traffic, for the
CPU tests: the same keys at toy widths (the backbone's from its ``TINY``),
float32 compute."""

from __future__ import annotations

import copy
import json
import os

from portbench import backbones

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load(kind: str, name: str) -> dict:
    with open(os.path.join(ROOT, kind, name + ".json")) as f:
        return json.load(f)


def tiny_config(name: str) -> dict:
    cfg = copy.deepcopy(load("configs", name))
    m = cfg["model"]
    backbone, group = backbones.load(m)
    group.update(copy.deepcopy(backbone.TINY))
    m["pixel_decoder"].update(conv_dim=32, mask_dim=32, transformer_layers=1,
                              transformer_ffn_dim=64, n_heads=4, n_points=2)
    m["decoder"].update(hidden_dim=32, num_queries=16, num_heads=4, dim_feedforward=64,
                        dec_layers=3, mask_dim=32)
    cfg["precision"]["compute"] = "float32"
    cfg["image_size"], cfg["mask_capacity"] = 64, 4
    cfg["criterion"]["num_points"] = 256
    return cfg


def tiny_traffic(name: str) -> dict:
    t = copy.deepcopy(load("traffic", name))
    t.update(images=12, short_side=[48, 80], batch=2, mapper_threads=2, prefetch=2,
             warmup_steps=1, trace_steps=2)
    return t
