"""The port's optimizer options (``engine/optim.py``) against the JAX
package's ``build_optimizer`` / ``build_schedule`` (optax) on the CPU.

- ``learning_rate(step, cfg)`` equals ``build_schedule(cfg)(step)`` for the
  multistep and poly schedules with a warm-up (rtol 1e-6: JAX computes the
  schedule in f32);
- six updates of the port's optimizer and of optax's chain on the same
  gradients (the first three above the clip norm, the rest below), over
  backbone and head parameters with and without decay and a frozen one:
  SGD with momentum (the default schedule, and poly with a warm-up, another
  backbone multiplier and momentum), SGD without clipping, AdamW with the
  poly schedule and a warm-up, multistep with its steps inside the run. The
  parameters after every update at 1e-6, the returned norm at rtol 1e-6;
- the default configuration's update is bit for bit the clipped
  ``torch.optim.AdamW`` step the train commands have taken so far;
- SGD's momentum survives ``state_dict`` / ``load_state_dict`` bit for bit;
- an unknown optimizer or schedule raises.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from partdistillation_torch.engine.optim import (AdamW, Optimizer, OptimizerConfig,
                                                 learning_rate)
from partdistillation_tpu.engine import optim as joptim

# (flax path, port name, shape): a frozen one, backbone and head, decay and not
PARAMS = [
    (("backbone", "block", "kernel"), "backbone.block.weight", (6, 5)),
    (("backbone", "norm", "scale"), "backbone.norm.weight", (5,)),
    (("backbone", "relative_position_bias_table"), "backbone.relative_position_bias_table",
     (9, 2)),
    (("pixel_decoder", "proj", "kernel"), "sem_seg_head.pixel_decoder.proj.weight", (4, 4)),
    (("predictor", "mlp", "kernel"), "sem_seg_head.predictor.mlp.weight", (7, 3)),
    (("predictor", "mlp", "bias"), "sem_seg_head.predictor.mlp.bias", (3,)),
    (("predictor", "query_feat"), "sem_seg_head.predictor.query_feat.weight", (8, 3)),
]


def _tree(values):
    tree = {}
    for (path, _, _), v in zip(PARAMS, values):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = v
    return {"params": tree}


def _leaves(tree):
    out = []
    for path, _, _ in PARAMS:
        node = tree["params"]
        for key in path:
            node = node[key]
        out.append(np.asarray(node))
    return out


@pytest.mark.parametrize("cfg", [
    OptimizerConfig(),
    OptimizerConfig(schedule="poly", max_iter=40, warmup_iters=5, warmup_factor=0.1),
    OptimizerConfig(steps=(3, 6), gamma=0.5, warmup_iters=4, warmup_factor=0.25),
    OptimizerConfig(schedule="poly", max_iter=7, poly_power=2.0, warmup_iters=0),
], ids=["default", "poly-warmup", "multistep-warmup", "poly-past-end"])
@pytest.mark.parametrize("step", [0, 1, 3, 4, 5, 6, 9, 10, 39, 40, 41, 45000])
def test_learning_rate_matches_jax_schedule(cfg, step):
    jcfg = joptim.OptimizerConfig(**{k: getattr(cfg, k) for k in (
        "base_lr", "schedule", "max_iter", "steps", "gamma", "warmup_iters", "warmup_factor",
        "poly_power")})
    np.testing.assert_allclose(learning_rate(step, cfg),
                               float(joptim.build_schedule(jcfg)(step)), rtol=1e-6)


CASES = {
    "sgd": dict(optimizer="sgd"),
    "sgd-poly-warmup": dict(optimizer="sgd", schedule="poly", max_iter=10, warmup_iters=3,
                            warmup_factor=0.1, backbone_multiplier=0.5, momentum=0.8,
                            weight_decay=0.01, base_lr=0.05),
    "sgd-no-clip": dict(optimizer="sgd", clip_norm=0.0, base_lr=0.01),
    "adamw-poly-warmup": dict(schedule="poly", max_iter=8, warmup_iters=4, warmup_factor=0.2,
                              base_lr=1e-3),
    "sgd-multistep-in-run": dict(optimizer="sgd", steps=(2, 4), gamma=0.3, base_lr=0.02),
}


@pytest.mark.parametrize("name", list(CASES))
def test_updates_match_optax(name):
    kw = dict(CASES[name], freeze_keys=("pixel_decoder",))
    rng = np.random.default_rng(len(name))
    init = [rng.standard_normal(shape).astype(np.float32) for _, _, shape in PARAMS]
    jparams = _tree([v.copy() for v in init])
    tx = joptim.build_optimizer(joptim.OptimizerConfig(**kw), jparams)
    state, update = tx.init(jparams), jax.jit(tx.update)
    params = {name_: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for (_, name_, _), v in zip(PARAMS, init)}
    opt = Optimizer(params.items(), OptimizerConfig(**kw))
    assert set(opt.labels.values()) == {"frozen", "backbone_decay", "backbone_nodecay",
                                        "head_decay", "head_nodecay"}
    for i, scale in enumerate((1.0, 2.0, 0.5, 1e-4, 3e-4, 1e-5)):
        grads = [(rng.standard_normal(shape) * scale).astype(np.float32)
                 for _, _, shape in PARAMS]
        updates, state = update(_tree(grads), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for (_, name_, _), g in zip(PARAMS, grads):
            params[name_].grad = torch.from_numpy(g.copy())
        norm = opt.step()
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(_tree(grads))),
                                   rtol=1e-6)
        for (path, name_, _), want in zip(PARAMS, _leaves(jparams)):
            np.testing.assert_allclose(params[name_].detach().numpy(), want, rtol=0, atol=1e-6,
                                       err_msg=f"{name} update {i}: {name_}")
    frozen = params["sem_seg_head.pixel_decoder.proj.weight"].detach().numpy()
    np.testing.assert_array_equal(frozen, init[3])


def test_default_is_the_clipped_adamw_step():
    """``OptimizerConfig()``: every CLI's update, bit for bit the clipped
    ``torch.optim.AdamW`` step at the multistep rate (1e-4, backbone x 0.1,
    decay 0.05 off the no-decay tensors)."""
    rng = np.random.default_rng(0)
    init = [rng.standard_normal(shape).astype(np.float32) for _, _, shape in PARAMS]
    params = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for (_, n, _), v in zip(PARAMS, init)}
    ref = {n: torch.nn.Parameter(torch.from_numpy(v.copy())) for (_, n, _), v in zip(PARAMS, init)}
    opt = AdamW(params.items(), OptimizerConfig())
    assert isinstance(opt, Optimizer)
    groups = {}
    for n, p in ref.items():
        groups.setdefault(opt.labels[n], []).append(p)
    adam = torch.optim.AdamW([{"params": ps, "lr_mult": 0.1 if k.startswith("backbone") else 1.0,
                               "weight_decay": 0.05 if k.endswith("_decay") else 0.0}
                              for k, ps in groups.items()],
                             lr=1e-4, betas=(0.9, 0.999), eps=1e-8, fused=True)
    for scale in (1.0, 1e-4, 2.0):
        grads = [torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32))
                 for _, _, s in PARAMS]
        for (_, n, _), g in zip(PARAMS, grads):
            params[n].grad, ref[n].grad = g.clone(), g.clone()
        opt.step()
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        live = [p for k, ps in groups.items() for p in ps]
        torch._foreach_mul_([p.grad for p in live], 0.01 / torch.clamp(norm, min=0.01))
        for g in adam.param_groups:
            g["lr"] = 1e-4 * g["lr_mult"]
        adam.step()
    for n in params:
        assert torch.equal(params[n], ref[n]), n


def test_sgd_state_dict_round_trip():
    cfg = OptimizerConfig(optimizer="sgd", base_lr=0.1)
    rng = np.random.default_rng(1)
    init = [rng.standard_normal(s).astype(np.float32) for _, _, s in PARAMS]
    grads = [[torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for _, _, s in PARAMS]
             for _ in range(4)]

    def fresh():
        ps = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for (_, n, _), v in zip(PARAMS, init)}
        return ps, Optimizer(ps.items(), cfg)

    def run(ps, opt, gs):
        for g in gs:
            for (_, n, _), t in zip(PARAMS, g):
                ps[n].grad = t.clone()
            opt.step()

    a, opt_a = fresh()
    run(a, opt_a, grads)
    b, opt_b = fresh()
    run(b, opt_b, grads[:2])
    state = opt_b.state_dict()
    assert state["count"] == 2 and set(state) == {"count", "sgd"}
    c, opt_c = fresh()
    with torch.no_grad():
        for n in c:
            c[n].copy_(b[n])
    opt_c.load_state_dict(state)
    run(c, opt_c, grads[2:])
    for n in a:
        assert torch.equal(a[n], c[n]), n


def test_unknown_options_raise():
    p = [("head.w", torch.nn.Parameter(torch.zeros(2, 2)))]
    with pytest.raises(ValueError, match="optimizer"):
        Optimizer(p, OptimizerConfig(optimizer="lamb"))
    with pytest.raises(ValueError, match="schedule"):
        Optimizer(p, OptimizerConfig(schedule="cosine"))
