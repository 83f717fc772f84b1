"""The slice as a whole on the CPU: one stage-3 train step of the port
(``Trainer.train_step`` over ``make_loss_fn``) against the JAX package's
``Trainer.train_step`` on the same initial weights, batch and randomness,
with DropPath active (rate 0.3), once with the trunk frozen as the stage-3 CLI
runs it, once unfrozen, and once unfrozen in the kernel configuration (the
JAX side's pixel decoder with ``msda_mode="pallas_folded"``, whose Pallas
kernel it runs in interpret mode, and Swin with ``fused_proj=True`` on both
sides).

The randomness: JAX's step splits ``key`` from ``Trainer.state.rng`` and
then ``k_drop, k_crit = split(key)``. The DropPath keep decisions depend on
``k_drop`` and the batch size only, so a separate ``model.apply`` with the
same key under ``flax.linen.intercept_methods`` records exactly the ones the
step uses; the matcher and point-grid jitter come from ``k_crit``'s
splits (``_jitter``). All of it goes to the port as its ``noise``.

Tolerances (f32): every loss and ``total_loss`` within 1e-5 relative,
``grad_norm`` within 1e-5 relative, each gradient within 1e-4 of its
tensor's max |grad| (the gradients themselves are compared: Adam's first
step moves every parameter by about lr whatever its gradient), updated
parameters within 1e-6, frozen parameters identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from partdistillation_tpu.engine.optim import OptimizerConfig as JOpt
from partdistillation_tpu.engine.trainer import Trainer as JTrainer
from partdistillation_tpu.losses.criterion import CriterionConfig as JCrit
from partdistillation_tpu.losses.matcher import MatcherConfig as JMatch
from partdistillation_tpu.models import segmenter as jseg
from partdistillation_tpu.models import swin as jswin
from partdistillation_tpu.models.meta_arch import proposal as jprop
from partdistillation_tpu.models.pixel_decoder import PixelDecoderConfig as JPD
from partdistillation_tpu.models.swin import SwinConfig as JSwin
from partdistillation_tpu.models.transformer_decoder import TransformerDecoderConfig as JTD
from partdistillation_torch.engine.optim import OptimizerConfig
from partdistillation_torch.engine.trainer import Trainer
from partdistillation_torch.losses.criterion import CriterionConfig
from partdistillation_torch.losses.matcher import MatcherConfig
from partdistillation_torch.models import segmenter as pseg
from partdistillation_torch.models.meta_arch import proposal as pprop
from partdistillation_torch.models.pixel_decoder import PixelDecoderConfig
from partdistillation_torch.models.swin import SwinConfig
from partdistillation_torch.models.transformer_decoder import TransformerDecoderConfig
from partdistillation_torch.utils.convert_weights import state_dict_from_flax

SW = dict(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), window_size=4,
          drop_path_rate=0.3)
PD = dict(conv_dim=32, mask_dim=32, transformer_layers=1, transformer_ffn_dim=64, n_heads=4,
          n_points=2)
TD = dict(num_classes=1, hidden_dim=32, num_queries=8, num_heads=4, dim_feedforward=64,
          dec_layers=2, mask_dim=32)
POINTS, SEED = 64, 3
FREEZE_KEYS = ("backbone", "pixel_decoder")


def _batch(rng, b=2, t=4, size=64):
    masks = np.zeros((b, t, size, size), bool)
    for i in range(b):
        for j in range(t):
            y0, x0 = rng.integers(0, size // 2, 2)
            masks[i, j, y0:y0 + rng.integers(8, size // 2), x0:x0 + rng.integers(8, size // 2)] = True
    valid = np.ones((b, t), bool)
    valid[0, -1] = valid[1, -2:] = False  # padded slots
    return {"image": rng.integers(0, 256, (b, size, size, 3)).astype(np.uint8),
            "masks": masks, "valid": valid}


def _jitter(key, layers, b, t):
    """The jitter JAX's set_criterion draws from ``key`` (see
    tests/test_torch_train_losses.py)."""
    match, pts = [], []
    for lk in jax.random.split(key, layers):
        k_match, k_pts = jax.random.split(lk)
        match.append([np.asarray(jax.random.uniform(k, (2,))) for k in jax.random.split(k_match, b)])
        keys = jax.random.split(k_pts, (b, t))
        pts.append([[np.asarray(jax.random.uniform(keys[i, j], (2,))) for j in range(t)]
                    for i in range(b)])
    return (torch.from_numpy(np.asarray(match, np.float32)),
            torch.from_numpy(np.asarray(pts, np.float32)))


def _drop_keep(jmodel, params, images, k_drop, depths):
    """JAX's DropPath keep decisions (blocks, 2, B) for ``k_drop``: an
    interceptor collects each active DropPath's per-image "output is not
    zero" while the forward traces, and the jitted forward returns them."""

    def record(params, images, k_drop):
        store = {}

        def interceptor(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            mod = context.module
            deterministic = args[1] if len(args) > 1 else kwargs.get("deterministic")
            if isinstance(mod, jswin.DropPath) and not deterministic and mod.rate > 0:
                store[f"{mod.parent.name}/{mod.name}"] = jnp.any(
                    out != 0, axis=tuple(range(1, out.ndim)))
            return out

        with nn.intercept_methods(interceptor):
            jmodel.apply(params, images, train=True, rngs={"dropout": k_drop})
        return store

    store = jax.jit(record)(params, images, k_drop)
    b = images.shape[0]
    keep = np.ones((sum(depths), 2, b), bool)
    i = 0
    for s, depth in enumerate(depths):
        for blk in range(depth):
            for w, which in enumerate(("drop_path1", "drop_path2")):
                keep[i, w] = np.asarray(store.get(f"stage{s}_block{blk}/{which}", keep[i, w]))
            i += 1
    return keep


# per case: (trunk frozen, the kernel configuration)
CASES = {"frozen": (True, False), "unfrozen": (False, False),
         "unfrozen_kernel_config": (False, True)}


def _run(frozen: bool, kernel_config: bool):
    rng = np.random.default_rng(0)
    batch = _batch(rng)
    jpd_opts = (dict(msda_mode="pallas_folded") if kernel_config
                else dict(msda_mode="banded", msda_band_radius=4))
    jseg_cfg = jseg.SegmenterConfig(
        swin=JSwin(**SW, fused_proj=kernel_config), pixel_decoder=JPD(**PD, **jpd_opts),
        decoder=JTD(**TD), freeze_backbone=frozen, freeze_pixel_decoder=frozen)
    jcfg = jprop.ProposalModelConfig(
        segmenter=jseg_cfg,
        criterion=JCrit(num_classes=1, num_points=POINTS, importance_sample_ratio=0.0,
                        matcher=JMatch(num_points=POINTS)))
    jmodel = jseg.MaskFormerSegmenter(jseg_cfg)
    images = jprop.normalize_images(jnp.asarray(batch["image"]))
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0), images))
    # random sampling-offset kernels so the deformable gather moves off the grid
    leaf = params["params"]["pixel_decoder"]["layer0"]["self_attn"]["sampling_offsets"]
    leaf["kernel"] = (rng.normal(size=leaf["kernel"].shape) * 0.05).astype(np.float32)
    init = state_dict_from_flax(params)

    freeze = FREEZE_KEYS if frozen else ()
    loss_fn = jprop.make_loss_fn(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    trainer = JTrainer(loss_fn=loss_fn, init_params=params,
                       optimizer_cfg=JOpt(freeze_keys=freeze), seed=SEED, donate=False)
    _, key = jax.random.split(trainer.state.rng)
    k_drop, k_crit = jax.random.split(key)
    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jbatch, key)
    jmetrics = trainer.train_step(jbatch)

    layers, (b, t) = 1 + TD["dec_layers"], batch["valid"].shape
    match_j, pts_j = _jitter(k_crit, layers, b, t)
    noise = {"drop_keep": torch.from_numpy(_drop_keep(jmodel, params, images, k_drop,
                                                      SW["depths"])),
             "match_jitter": match_j, "point_jitter": pts_j}

    pcfg = pprop.ProposalModelConfig(
        segmenter=pseg.SegmenterConfig(
            swin=SwinConfig(**SW, fused_proj=kernel_config),
            pixel_decoder=PixelDecoderConfig(**PD),
            decoder=TransformerDecoderConfig(**TD), freeze_backbone=frozen,
            freeze_pixel_decoder=frozen),
        criterion=CriterionConfig(num_classes=1, num_points=POINTS,
                                  matcher=MatcherConfig(num_points=POINTS)))
    model = pseg.MaskFormerSegmenter(pcfg.segmenter, device="cpu")
    model.load_state_dict(init, strict=True)
    ptrainer = Trainer(pprop.make_loss_fn(pcfg, model, device="cpu"), model,
                       OptimizerConfig(freeze_keys=freeze), device="cpu")
    grads, apply = {}, ptrainer.apply_gradients

    def apply_after_snapshot():  # the update clips the gradients in place
        grads.update({n: None if p.grad is None else p.grad.clone()
                      for n, p in model.named_parameters()})
        return apply()

    ptrainer.apply_gradients = apply_after_snapshot
    pmetrics = ptrainer.train_step(batch, noise)
    return dict(jmetrics=jmetrics, jlosses=jlosses, jgrads=state_dict_from_flax(jgrads),
                jparams=state_dict_from_flax(jax.tree_util.tree_map(
                    np.asarray, trainer.state.params)),
                pmetrics=pmetrics, model=model, grads=grads, init=init, noise=noise)


@pytest.fixture(scope="module", params=list(CASES))
def step(request):
    return request.param, _run(*CASES[request.param])


def test_noise_drops_some_paths(step):
    keep = step[1]["noise"]["drop_keep"]
    assert keep[0].all() and not keep.all()  # block 0 has rate 0; the key drops others


def test_losses_match(step):
    r = step[1]
    names = set(r["jlosses"]) | {"total_loss"}
    assert set(r["pmetrics"]) == names | {"grad_norm"} and len(r["jlosses"]) == 9
    for name in names:
        np.testing.assert_allclose(r["pmetrics"][name], float(r["jmetrics"][name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(r["pmetrics"]["grad_norm"], float(r["jmetrics"]["grad_norm"]),
                               rtol=1e-5)


def test_gradients_match(step):
    """Each gradient within 1e-4 of its max |grad|. A tensor whose gradient
    vanishes in exact arithmetic (the res2 output norm's bias: its shift
    passes a 1x1 conv into a GroupNorm, which removes it) holds only rounding
    noise, below 1e-6 of the step's largest gradient in both packages."""
    kind, r = step
    grads = r["grads"]
    floor = 1e-6 * max(g.abs().max().item() for g in r["jgrads"].values())
    trunk = 0
    for name, want in r["jgrads"].items():
        got = grads[name]
        in_trunk = name.startswith(("backbone.", "sem_seg_head.pixel_decoder."))
        if kind == "frozen" and in_trunk:
            assert got is None and not want.any(), name
            continue
        trunk += in_trunk
        scale = want.abs().max().item()
        if scale < floor:
            assert got.abs().max().item() < floor, name
            continue
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
    assert trunk == (0 if kind == "frozen" else sum(
        n.startswith(("backbone.", "sem_seg_head.pixel_decoder.")) for n in grads))


def test_updated_parameters_match(step):
    kind, r = step
    for name, p in r["model"].named_parameters():
        want = r["jparams"][name]
        np.testing.assert_allclose(p.detach().numpy(), want.numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
        frozen = kind == "frozen" and name.startswith(("backbone.", "sem_seg_head.pixel_decoder."))
        assert torch.equal(p.detach(), r["init"][name]) == frozen, name


def test_checkpoint_save_and_resume(tmp_path):
    """``save`` / ``resume_or_load``: a new Trainer on the same directory
    resumes the newest of at most three checkpoints, with the step count,
    the parameters, the optimizer state and the noise generator."""
    cfg = pprop.ProposalModelConfig(
        segmenter=pseg.SegmenterConfig(
            swin=SwinConfig(**SW), pixel_decoder=PixelDecoderConfig(**PD),
            decoder=TransformerDecoderConfig(**TD), freeze_backbone=True,
            freeze_pixel_decoder=True),
        criterion=CriterionConfig(num_classes=1, num_points=POINTS,
                                  matcher=MatcherConfig(num_points=POINTS)))
    batch = _batch(np.random.default_rng(1))

    def trainer(seed):
        model = pseg.MaskFormerSegmenter(cfg.segmenter, device="cpu", seed=seed)
        return Trainer(pprop.make_loss_fn(cfg, model, device="cpu"), model,
                       OptimizerConfig(freeze_keys=FREEZE_KEYS), device="cpu", seed=seed,
                       checkpoint_dir=str(tmp_path / "ck"))

    t1 = trainer(0)
    assert not t1.resume_or_load()
    for _ in range(4):
        t1.train_step(batch)
        t1.save()
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        f"model_{s:08d}.pt" for s in (2, 3, 4)]
    t2 = trainer(1)
    assert t2.resume_or_load() and t2.step == 4
    for (n, a), (_, b) in zip(t1.model.named_parameters(), t2.model.named_parameters()):
        assert torch.equal(a, b), n
    m1, m2 = t1.train_step(batch), t2.train_step(batch)
    assert m1 == m2
