"""The frozen reference against the system under test's plain path, at a tiny
size on the CPU in float64, on the benchmark's seeded weights: the eval
forward, and one training-mode loss with its gradients under the same crop
offsets. Also the reference's work counts at the published sizes (on the
``meta`` device)."""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

import pytest
import torch

from benchmark import inputs
from benchmark.families import cfpnet
from benchmark.reference import counters, geometry
from benchmark.reference import model as ref
from benchmark.reference import train as ref_train

HERE = Path(__file__).resolve().parents[1]
TINY = dict(n_bins=16, native_height=64, native_width=96, eval_zone_num_cfg=2, eval_patch_px=16,
            input_height=48, input_width=64, train_zone_num=2, train_patch_px=16)
CONFIGS = ("cfpnet_combine1", "deltar_baseline")


def settings(name, tiny=True):
    s = json.loads((HERE / "configs" / f"{name}.json").read_text())["settings"]
    return dict(s, **TINY) if tiny else s


def port_model(s, mode):
    from cfpnet_torch.models.deltar import make_model

    config = cfpnet.port_config(s, mode=mode, tiny_model=True, bs=2)
    return config, make_model(config, device="cpu").double()


@pytest.mark.parametrize("name", CONFIGS)
def test_state_dict_names_match_the_port(name):
    from cfpnet_torch.models.deltar import make_model

    s = settings(name, tiny=False)
    port = make_model(cfpnet.port_config(s, mode="online_eval"), device="meta").state_dict()
    mine = ref.build(s, "meta").state_dict()
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: tuple(v.shape) for k, v in mine.items()}


@pytest.mark.parametrize("name", CONFIGS)
def test_eval_forward_matches_the_port(name):
    from cfpnet_torch.models.deltar import model_geometries

    s = settings(name)
    sd = {k: v.double() for k, v in cfpnet.init_state(s, 7, "cpu", tiny=True).items()}
    data = {k: torch.from_numpy(v) for k, v in inputs.make(s, "online_eval", 2, 3).items()}
    image, hist = data["image"].double(), data["hist_data"].double()
    config, port = port_model(s, "online_eval")
    port.load_state_dict(sd)
    mine = ref.build(s, "cpu", ref.TINY).double()
    mine.load_state_dict(sd)
    with torch.no_grad():
        pe, pp = port(image, hist, data["mask"], model_geometries(config, "online_eval"))[:2]
        re, rp = mine(image, hist, data["mask"], geometry.for_mode(s, "online_eval"))
    torch.testing.assert_close(re, pe, rtol=1e-10, atol=0)
    torch.testing.assert_close(rp, pp, rtol=1e-10, atol=0)


def test_train_loss_and_gradients_match_the_port():
    from cfpnet_torch.models.deltar import model_geometries
    from cfpnet_torch.train import steps

    s = settings("cfpnet_combine1")
    sd = {k: v.double() for k, v in cfpnet.init_state(s, 5, "cpu", tiny=True).items()}
    data = {k: torch.from_numpy(v) for k, v in inputs.make(s, "train", 4, 9).items()}
    data = {k: v.double() if v.is_floating_point() else v for k, v in data.items()}
    config, port = port_model(s, "train")
    port.load_state_dict(sd)
    loss = steps.make_loss_fn(port, config, model_geometries(config, "train"))(
        data, steps.step_generator(11))
    loss.backward()
    mine = ref.build(s, "cpu", ref.TINY).double()
    mine.load_state_dict(sd)
    mine.train()
    _, pred = mine(data["image"], data["hist_data"], data["mask"],
                   geometry.for_mode(s, "train"), ref_train.step_generator(11))
    want = ref_train.silog(pred, data["depth"], s["min_depth"])
    want.backward()
    torch.testing.assert_close(want, loss, rtol=1e-10, atol=0)
    grads = dict(mine.named_parameters())
    scale = max(float(p.grad.abs().max()) for p in grads.values())
    for name, p in port.named_parameters():
        torch.testing.assert_close(grads[name].grad, p.grad, rtol=0, atol=1e-9 * scale)


def test_the_optimizer_matches_the_port():
    """Three AdamW steps of the reference against the port's optimizer on the
    same float32 parameters and gradients (both compute the step's scalars
    in the parameters' dtype)."""
    from cfpnet_torch.train.optim import AdamW

    s = settings("cfpnet_combine1")
    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Module()
    model.img_encoder = torch.nn.Linear(3, 4)
    model.decoder = torch.nn.Linear(4, 2)
    twin = torch.nn.Module()
    twin.img_encoder = torch.nn.Linear(3, 4)
    twin.decoder = torch.nn.Linear(4, 2)
    twin.load_state_dict(model.state_dict())
    mine = ref_train.AdamW(model, s, s["total_steps"])
    port = AdamW(twin.named_parameters(), s["lr"], s["total_steps"], wd=s["wd"],
                 div_factor=s["div_factor"], final_div_factor=s["final_div_factor"],
                 hist_encoder_10x=True)
    for _ in range(3):
        for a, b in zip(model.parameters(), twin.parameters()):
            a.grad = torch.randn(a.shape, generator=gen)
            b.grad = a.grad.clone()
        mine.step()
        port.step()
    for a, b in zip(model.parameters(), twin.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,flops,calls", [
    ("cfpnet_combine1", 95_013_863_680, {"fused_loftr": 18, "dwconv": 6, "linear_attention": 6}),
    ("deltar_baseline", 83_441_959_168, {"fused_loftr": 18})])
def test_work_counts(name, flops, calls):
    got, found = counters.count(settings(name, tiny=False), "online_eval", 1)
    assert got == flops
    assert Counter(k for k, _ in found) == calls


def test_train_step_flops():
    assert counters.train_step_flops(settings("cfpnet_combine1", tiny=False)) == 3_350_829_490_176


def test_least_time_of_a_forward():
    _, calls = counters.count(settings("cfpnet_combine1", tiny=False), "online_eval", 1)
    ms = {k: sum(counters.least_ms(c, shape, "bfloat16") for c, shape in calls if c == k)
          for k in ("fused_loftr", "dwconv")}
    assert ms["fused_loftr"] == pytest.approx(0.009648, rel=1e-3)
    assert ms["dwconv"] == pytest.approx(0.039826, rel=1e-3)
