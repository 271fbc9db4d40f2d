"""The port's device pipeline (``cfpnet_torch/data/tof_sim_device.py``)
against ``cfpnet_tpu/data/tof_sim_jax.py`` on the CPU: each function on
seeded numpy inputs, and ``device_preprocess`` in train and eval mode on
uint8 and float32 images, with the draws rebuilt from the JAX function's
own key splits (``jax_draws``). Histograms, masks, depths and points are
equal bit for bit (float32); the image within 1e-6 (float32: the JAX
program fuses the photometric chain into other roundings). The JAX
functions run jitted, as ``device_preprocess`` runs them: XLA on the CPU
contracts ``a * b + c`` into one fused multiply-add inside a jitted
program, and the port's sampling does the same. Then the drop and noise
marginals of the port's own draws (after ``tests/test_aug_equivalence.py``)
and the transform under deterministic algorithms."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfpnet_torch.config import Config as PtConfig
from cfpnet_torch.data import tof_sim as pt_host
from cfpnet_torch.data import tof_sim_device as tsd
from cfpnet_torch.data.geometry import ZoneGeometry as PtGeometry
from cfpnet_tpu.data import tof_sim_jax as tsj
from cfpnet_tpu.data.geometry import ZoneGeometry as JxGeometry

torch.set_num_threads(1)  # tiny ops, shared cores (tests/torch_port_util.py)

B, H, W, ZN, PX = 3, 96, 128, 4, 16
Z = ZN * ZN
AUG = dict(drop_hist=0.34, noise_prob=0.3, noise_mean=0.17, noise_sigma=0.2)
JG = JxGeometry(img_h=H, img_w=W, zone_num=ZN, patch_px_h=PX, patch_px_w=PX, offset_y=3,
                offset_x=-5)
PG = PtGeometry(img_h=H, img_w=W, zone_num=ZN, patch_px_h=PX, patch_px_w=PX, offset_y=3,
                offset_x=-5)


def t(a):
    return torch.from_numpy(np.array(a))


def depth_maps(seed, batch=B, h=H, w=W):
    """Smooth depth in 0.2..4.6 m with noise, invalid (0) pixels, pixels
    beyond 4 m, and exact multiples of the bin width and their float32
    neighbours (no subnormals: XLA on the CPU flushes them to zero)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d = np.stack([0.2 + 1.6 * np.sin(yy / (11 + 4 * b)) ** 2 + 2.8 * np.cos(xx / 19) ** 2
                  for b in range(batch)])
    d += 0.03 * rng.standard_normal(d.shape)
    d = d.astype(np.float32)
    d[rng.random(d.shape) < 0.03] = 0.0
    edges = np.arange(1, 101, dtype=np.float32) * np.float32(pt_host.BIN_WIDTH)
    for b in range(batch):
        pick = rng.random((h, w)) < 0.05
        e = rng.choice(edges, pick.sum())
        e = np.where(rng.random(e.shape) < 0.5, e, np.nextafter(e, np.float32(0)))
        d[b][pick] = e
    return d


def jax_hist_draws(key, batch, zones):
    """``augment_hist_jax``'s draws: split(key, 3) -> drop, hit, normal."""
    k1, k2, k3 = jax.random.split(key, 3)
    return dict(drop=jax.random.uniform(k1, (batch, zones)),
                noise_hit=jax.random.uniform(k2, (batch, zones)),
                noise_normal=jax.random.normal(k3, (batch, zones)))


def jax_photo_draws(key, batch):
    """``photometric_augment_jax``'s draws: split(key, 4) -> do, gamma,
    brightness, colors."""
    k0, k1, k2, k3 = jax.random.split(key, 4)
    u = jax.random.uniform
    return dict(photo=u(k0, (batch, 1, 1, 1)).reshape(batch),
                gamma=u(k1, (batch, 1, 1, 1), minval=0.9, maxval=1.1).reshape(batch),
                brightness=u(k2, (batch, 1, 1, 1), minval=0.75, maxval=1.25).reshape(batch),
                colors=u(k3, (batch, 1, 1, 3), minval=0.9, maxval=1.1).reshape(batch, 3))


def jax_draws(key, batch, zones):
    """Every draw of ``device_preprocess(…, rng=key)`` in train mode, as the
    port's ``draw_augmentations`` keys them."""
    k_flip, k_phot, k_hist = jax.random.split(key, 3)
    d = dict(flip=jax.random.uniform(k_flip, (batch, 1, 1, 1)).reshape(batch),
             **jax_photo_draws(k_phot, batch), **jax_hist_draws(k_hist, batch, zones))
    return {k: t(np.asarray(v)) for k, v in d.items()}


def assert_same(got, ref, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, (what, got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref, err_msg=what)


@functools.lru_cache(maxsize=None)
def jax_sample_points(zone_sample_num, sample_uniform):
    return jax.jit(functools.partial(tsj.sample_points_jax, zone_sample_num=zone_sample_num,
                                     sample_uniform=sample_uniform))


@pytest.fixture(scope="module")
def depth():
    return depth_maps(0)


@pytest.fixture(scope="module")
def jax_hist(depth):
    """The JAX histograms and (fh, mask) of ``depth``, compiled once."""
    hist = tsj.zone_histograms_jax(jnp.asarray(depth), JG, 4.0)
    fh, mask = tsj.get_hist_jax(jnp.asarray(depth), JG, 4.0)
    return np.asarray(hist), np.asarray(fh), np.asarray(mask)


def test_zone_histograms_equal_jax(depth, jax_hist):
    """Counts in integers, bit for bit, at the bin edges too; pixels at 4 m
    land in the last bin and beyond it nowhere."""
    got = tsd.zone_histograms(t(depth), PG, 4.0)
    assert_same(got.numpy(), jax_hist[0], "histograms")
    assert got.sum() < depth[:, PG.sy_px:, PG.sx_px:].size


def test_strongest_cluster_equals_jax():
    """Whole-number histograms with runs of equal sums (ties to the first)."""
    rng = np.random.default_rng(1)
    hist = ((rng.random((40, 60)) < 0.4) * rng.integers(1, 6, (40, 60))).astype(np.float32)
    hist[0] = 0.0
    hist[1, :] = 0.0
    hist[1, [3, 4, 10, 11, 20]] = [2, 3, 4, 1, 5]  # runs 5, 5, 5: the first wins
    ref = np.asarray(jax.jit(tsj.strongest_cluster_jax)(jnp.asarray(hist)))
    got = tsd.strongest_cluster(t(hist)).numpy()
    assert_same(got, ref, "strongest cluster")
    np.testing.assert_array_equal(got[1], [0, 0, 0, 2, 3] + [0] * 55)


def test_get_hist_equals_jax_and_the_host(depth, jax_hist):
    """(mu, sigma) and the mask bit for bit against ``get_hist_jax``; against
    the port's host ``tof_sim.get_hist`` (the loader's path) the mask
    exactly and (mu, sigma) within 1e-5 (the sums in another order)."""
    fh, mask = tsd.get_hist(t(depth), PG, 4.0)
    assert_same(fh.numpy(), jax_hist[1], "fh")
    assert_same(mask.numpy(), jax_hist[2], "mask")
    assert mask.any() and not mask.all()
    for b in range(B):
        hfh, _, hmask = pt_host.get_hist(depth[b], PG, 4.0)
        np.testing.assert_array_equal(mask[b].numpy(), hmask)
        np.testing.assert_allclose(fh[b].numpy(), hfh, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sample_uniform", [True, False])
def test_sample_points_equal_jax(jax_hist, sample_uniform):
    """Both reference modes, bit for bit against the jitted JAX function;
    invalid zones 0."""
    fh, mask = jax_hist[1], jax_hist[2]
    ref = jax_sample_points(16, sample_uniform)(jnp.asarray(fh), jnp.asarray(mask))
    got = tsd.sample_points(t(fh), t(mask), 16, sample_uniform)
    assert_same(got.numpy(), ref, "points")
    assert (got.numpy()[~mask] == 0).all()


@pytest.mark.parametrize("aug", [AUG, dict(AUG, drop_hist=0.58), dict(AUG, noise_prob=0.0),
                                 dict(AUG, drop_hist=0.0)])
def test_augment_hist_equals_jax(jax_hist, aug):
    """Zone dropout and mu noise with the draws of the JAX key, bit for bit
    (p = 0.58 is where a float32 drop count would round across an
    integer)."""
    fh, mask = jax_hist[1], jax_hist[2]
    key = jax.random.key(5)
    ref_fh, ref_mask = jax.jit(functools.partial(tsj.augment_hist_jax, **aug))(
        jnp.asarray(fh), jnp.asarray(mask), key)
    draws = {k: t(np.asarray(v)) for k, v in jax_hist_draws(key, B, Z).items()}
    got_fh, got_mask = tsd.augment_hist(t(fh), t(mask), draws, **aug)
    assert_same(got_fh.numpy(), ref_fh, "fh")
    assert_same(got_mask.numpy(), ref_mask, "mask")


def test_drop_table_is_the_float64_count():
    """m = floor(n * p) in float64: at p = 0.58, n = 50 it is 28 (a float32
    product gives 29), so p_eff is 1 - (49/50)^28."""
    table = tsd._drop_table(64, 0.58)
    assert np.float32(50) * np.float32(0.58) >= 29 and int(50 * 0.58) == 28
    one = np.float32(1)
    assert table[50] == one - (one - one / np.float32(50)) ** np.float32(28)
    assert table[0] == 0 and table.dtype == np.float32


def test_photometric_augment_equals_jax():
    rng = np.random.default_rng(2)
    img = rng.random((4, 24, 32, 3)).astype(np.float32)
    key = jax.random.key(9)
    ref = jax.jit(tsj.photometric_augment_jax)(jnp.asarray(img), key)
    draws = {k: t(np.asarray(v)) for k, v in jax_photo_draws(key, 4).items()}
    got = tsd.photometric_augment(t(img), draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    assert (got.numpy() != img).any() and (got.numpy() == img).reshape(4, -1).all(1).any()


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("uint8", [True, False])
def test_device_preprocess_equals_jax(depth, train, uint8):
    """The whole tail in train and eval mode on uint8 and float32 images:
    depth (flipped with the image), hist_data and mask bit for bit, the
    normalized image within 1e-6."""
    rng = np.random.default_rng(3 + uint8)
    img = ((rng.random((B, H, W, 3)) * 255).astype(np.uint8) if uint8
           else rng.random((B, H, W, 3)).astype(np.float32))
    key = jax.random.key(11)
    kw = dict(max_distance=4.0, zone_sample_num=16, train=train, sample_uniform=True, **AUG)
    ref = tsj.device_preprocess(jnp.asarray(img), jnp.asarray(depth), key, JG, **kw)
    draws = jax_draws(key, B, Z) if train else None
    got = tsd.device_preprocess(t(img), t(depth), draws, PG, **kw)
    assert set(got) == set(ref)
    for k in ("depth", "hist_data", "mask"):
        assert_same(got[k].numpy(), ref[k], k)
    assert got["image"].dtype == torch.float32
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(ref["image"]), rtol=0,
                               atol=1e-6)
    if train:  # the draws flipped some samples and left others
        flipped = draws["flip"].numpy() > 0.5
        assert flipped.any() and not flipped.all()


def test_draws_follow_the_config():
    """Shapes, ranges and the generator's device; the hist draws only where
    the config uses them, as the JAX function draws them; the same seed
    gives the same draws."""
    cfg = PtConfig(**AUG)
    g = torch.Generator().manual_seed(4)
    d = tsd.draw_augmentations(g, 64, 36, cfg)
    assert set(d) == {"flip", "photo", "gamma", "brightness", "colors", "drop", "noise_hit",
                      "noise_normal"}
    assert all(v.dtype == torch.float32 and v.device == g.device for v in d.values())
    assert d["colors"].shape == (64, 3) and d["drop"].shape == (64, 36)
    for k, (lo, hi) in dict(flip=(0, 1), photo=(0, 1), gamma=(0.9, 1.1),
                            brightness=(0.75, 1.25), colors=(0.9, 1.1)).items():
        assert lo <= float(d[k].min()) and float(d[k].max()) <= hi, k
    again = tsd.draw_augmentations(torch.Generator().manual_seed(4), 64, 36, cfg)
    assert all(torch.equal(d[k], again[k]) for k in d)
    plain = tsd.draw_augmentations(g, 2, 36, cfg.replace(drop_hist=0.0, noise_prob=0.0))
    assert set(plain) == {"flip", "photo", "gamma", "brightness", "colors"}


# ---- the port's own draws: the marginals of tests/test_aug_equivalence.py ----------

P_DROP, N_ZONES = 0.34, 64
P_EFF = 1.0 - (1.0 - 1.0 / N_ZONES) ** int(N_ZONES * P_DROP)  # ~0.2813


def _port_aug(trials, mask, seed, **aug):
    cfg = PtConfig(**dict(dict(drop_hist=0.0, noise_prob=0.0), **aug))
    fh = torch.stack([torch.full((trials, N_ZONES), 2.0), torch.full((trials, N_ZONES), 0.1)],
                     dim=-1)
    draws = tsd.draw_augmentations(torch.Generator().manual_seed(seed), trials, N_ZONES, cfg)
    return tsd.augment_hist(fh, mask, draws, cfg.drop_hist, cfg.noise_prob, cfg.noise_mean,
                            cfg.noise_sigma)


def test_drop_marginal_is_the_with_replacement_one():
    _, m = _port_aug(1500, torch.ones(1500, N_ZONES, dtype=torch.bool), 1, drop_hist=P_DROP)
    rate = 1.0 - float(m.float().mean())
    assert abs(rate - P_EFF) < 0.012, (rate, P_EFF)
    assert abs(rate - P_DROP) > 0.03


def test_drop_scales_with_valid_count():
    n, trials = 16, 3000
    mask = torch.zeros(trials, N_ZONES, dtype=torch.bool)
    mask[:, :n] = True
    _, m = _port_aug(trials, mask, 2, drop_hist=P_DROP)
    got = 1.0 - float(m[:, :n].float().mean())
    expect = 1.0 - (1.0 - 1.0 / n) ** int(n * P_DROP)
    assert abs(got - expect) < 0.015, (got, expect)
    assert not m[:, n:].any()


def test_noise_marginals_match_the_reference():
    """mu noise on valid zones w.p. noise_prob, N(noise_mean, noise_sigma)
    (reference nyu.py:159-163); sigma untouched."""
    prob, mean, sigma, trials = 0.30, 0.17, 0.20, 1200
    fh, m = _port_aug(trials, torch.ones(trials, N_ZONES, dtype=torch.bool), 3,
                      noise_prob=prob, noise_mean=mean, noise_sigma=sigma)
    d = fh[..., 0].numpy() - 2.0
    assert m.all() and (fh[..., 1] == 0.1).all()
    assert abs((d != 0).mean() - prob) < 0.01
    assert abs(d.mean() - prob * mean) < 0.005
    hit = d[d != 0]
    assert abs(hit.mean() - mean) < 0.01 and abs(hit.std() - sigma) < 0.01


def test_transform_under_deterministic_algorithms(depth):
    """The integer counts need no op without a deterministic implementation,
    and two calls give the same bits."""
    old = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        draws = tsd.draw_augmentations(torch.Generator().manual_seed(0), B, Z, PtConfig(**AUG))
        img = torch.rand(B, H, W, 3, generator=torch.Generator().manual_seed(1))
        runs = [tsd.device_preprocess(img, t(depth), draws, PG, **AUG) for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(old)
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
