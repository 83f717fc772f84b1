"""What the harness reads for a configuration does not move when its code is
rearranged: the seeded weights, the step's noise, the FLOP count behind
``mfu.train`` and the reference's three steps, each against the value
recorded from the harness before its backbone, task and store moved behind
lookups by name.

  python3 -m portbench.tests.test_portbench_pins

prints the readings as JSON (how the recorded values were taken)."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest
import torch

from portbench import check, flops, train
from portbench.tests.tiny import load, tiny_config, tiny_traffic
from portbench.weights import make_weights

SEED = 3_000_000_041
# (configuration, traffic, whether its rows carry part labels)
CELLS = [("m2f-swinL-supervised", "supervised_train", True),
         ("m2f-swinL-proposal", "stage3_train", False)]

RECORDED = {
    "m2f-swinL-supervised": {
        "weights": "d95d3405ec9c056ec32efca0018df638c5b7cb4a1a401ecd31fa5aa1f0b2a038",
        "noise": "c5c4491c655b6d4c88e995c1664d662a8fcaa81e3ebbc54c89171cd322eefaac",
        "flops": 10048015925248,
        "loss": [67.08048248291016, 67.68759155273438, 66.33265686035156],
        "grad": "4ccdef338412ae4abd816cca9660a0d0bb347c7704886d3099cacdf26d689465",
        "change": "acaa2798aeb8c1fe55cffc0845334cd76ad2e10ec26fc77029e42a8817707a99",
    },
    "m2f-swinL-proposal": {
        "weights": "0c2f1348f2d53c00b6a5587045e8adee09253b85beab66642a50b510408c9f6b",
        "noise": "2a5cd1d62ebc07a2e38c19cfd8f3a2e69c3e11a49890422ef2928a8b82cc5b40",
        "flops": 7213145260032,
        "loss": [36.00703430175781, 35.594329833984375, 34.94847106933594],
        "grad": "8005f30b62d9a73341d268843a29db2c36aa8e33b3c5d133d0385e8a7aae5fb4",
        "change": "50f12aa8c730e73f9b279882f3d2fcfc0250906f3c6dbe244340ef8b545788e8",
    },
}


def _digest(named) -> str:
    h = hashlib.sha256()
    for name, t in named:
        t = t.detach().cpu().contiguous()
        h.update(f"{name} {tuple(t.shape)} {t.dtype}".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def _floats(d: dict) -> str:
    return hashlib.sha256(json.dumps([[k, repr(v)] for k, v in d.items()]).encode()).hexdigest()


def rows(cfg: dict, traffic: dict, labels: bool, seed: int, steps: int = 3) -> list:
    """``steps`` checked batches as the wire format's rows would give them:
    uint8 images, boolean rectangles for masks, and part labels where the
    task's rows carry them."""
    rng = np.random.default_rng(seed)
    s, t, b = cfg["image_size"], cfg["mask_capacity"], traffic["batch"]
    out = []
    for _ in range(steps):
        masks = np.zeros((b, t, s, s), bool)
        valid = np.zeros((b, t), bool)
        for i in range(b):
            for j in range(int(rng.integers(1, t + 1))):
                y0, x0 = rng.integers(0, s - 8, 2)
                h, w = rng.integers(4, s // 2, 2)
                masks[i, j, y0:y0 + h, x0:x0 + w] = True
                valid[i, j] = True
        row = {"image": rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8), "masks": masks,
               "valid": valid}
        if labels:
            row["labels"] = rng.integers(0, cfg["criterion"]["num_classes"], (b, t))
        out.append(row)
    return out


def noises(cfg: dict, traffic: dict, seed: int, steps: int = 3) -> list:
    g = torch.Generator()
    g.manual_seed(seed)
    return [train.draw_noise(cfg, traffic["batch"], cfg["mask_capacity"], g, "cpu")
            for _ in range(steps)]


def readings(config: str, traffic_name: str, labels: bool) -> dict:
    cfg, traffic = tiny_config(config), tiny_traffic(traffic_name)
    noise = noises(cfg, traffic, SEED)
    torch.set_num_threads(1)
    ref = check.run_reference(cfg, SEED, rows(cfg, traffic, labels, SEED), noise, "cpu")
    return {"weights": _digest(make_weights(cfg["model"], SEED, "cpu").items()),
            "noise": _digest((f"{i}.{k}", v) for i, n in enumerate(noise) for k, v in n.items()),
            "flops": flops.train_step_flops(load("configs", config),
                                            load("traffic", traffic_name)["batch"]),
            "loss": ref["loss"], "grad": _floats(ref["grad"]), "change": _floats(ref["change"])}


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("config,traffic,labels", CELLS)
def test_readings_equal_the_recorded(one_thread, config, traffic, labels):
    assert readings(config, traffic, labels) == RECORDED[config]


if __name__ == "__main__":
    print(json.dumps({c: readings(c, t, lab) for c, t, lab in CELLS}, indent=1))
