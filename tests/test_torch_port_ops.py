"""Port ops against the JAX package, float64 on the CPU: linear attention,
the large-kernel depthwise conv, the align-corners resizes, and the
dispatch rules (CPU tensors take the plain version; an unmasked call on
another device never falls back; a masked call takes the plain route).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfpnet_torch.kernels import dwconv as dwconv_kernel
from cfpnet_torch.kernels import linear_attention as attention_kernel
from cfpnet_torch.ops import dispatch
from cfpnet_torch.ops.attention import linear_attention as port_attention
from cfpnet_torch.ops.dwconv import depthwise_conv2d as port_dwconv
from cfpnet_torch.ops.interp import resize_bilinear_align_corners
from cfpnet_tpu.ops.attention import linear_attention as jax_attention
from cfpnet_tpu.ops.dwconv import depthwise_conv2d as jax_dwconv
from cfpnet_tpu.ops.interp import resize_bilinear_align_corners as jax_resize
from cfpnet_tpu.ops.pallas_attention import linear_attention_blockdiag, linear_attention_pallas
from tests.torch_port_util import close, enable_x64, t


def _qkv(N, L, S, H, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, L, H, D)), rng.standard_normal((N, S, H, D)),
            rng.standard_normal((N, S, H, D)))


@pytest.mark.parametrize("D", [4, 8, 16, 32])
def test_attention_matches_jax_f64(D):
    H = 128 // D if D > 16 else 4
    q, k, v = _qkv(3, 21, 13, H, D, seed=D)
    got = port_attention(t(q), t(k), t(v)).numpy()
    assert got.dtype == np.float64
    with enable_x64():
        ref = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
        N, L, _, _ = q.shape
        flat = [jnp.asarray(a.reshape(a.shape[0], a.shape[1], H * D)) for a in (q, k, v)]
        blockdiag = np.asarray(linear_attention_blockdiag(*flat, nhead=H)).reshape(N, L, H, D)
    close(got, ref)
    close(got, blockdiag)
    # the kernel wrapper takes the plain version for a CPU tensor
    close(attention_kernel.linear_attention(t(q), t(k), t(v)).numpy(), ref)
    close(dispatch.attention(t(q), t(k), t(v)).numpy(), ref)


@pytest.mark.parametrize("D", [4, 8, 16, 32])
def test_attention_matches_pallas_interpret(D):
    """The TPU kernel itself, run in interpret mode, against the port's plain
    version. Its products return f32 whatever the input dtype
    (``preferred_element_type``), so it is held at f32 tolerance."""
    H = 4
    q, k, v = (a.astype(np.float32) for a in _qkv(2, 16, 16, H, D, seed=10 + D))
    N, L = q.shape[:2]
    flat = [jnp.asarray(a.reshape(a.shape[0], a.shape[1], H * D)) for a in (q, k, v)]
    ref = np.asarray(linear_attention_pallas(*flat, nhead=H, interpret=True)).reshape(N, L, H, D)
    got = port_attention(t(q).double(), t(k).double(), t(v).double()).numpy()
    close(got, ref, rtol=2e-5, atol=1e-6)


def test_masked_attention_matches_jax_f64():
    q, k, v = _qkv(2, 9, 7, 4, 8, seed=3)
    rng = np.random.default_rng(4)
    q_mask = rng.random((2, 9)) > 0.3
    kv_mask = rng.random((2, 7)) > 0.3
    kv_mask[:, 0] = True
    got = dispatch.attention(t(q), t(k), t(v), t(q_mask), t(kv_mask)).numpy()
    with enable_x64():
        ref = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       q_mask=jnp.asarray(q_mask), kv_mask=jnp.asarray(kv_mask)))
    close(got, ref)


@pytest.mark.parametrize("k", [7, 15, 31])
def test_dwconv_matches_jax_f64(k):
    """f64 inputs take the JAX package's f64 DFT path for k >= 13 (and for a
    kernel that covers the map), the dense conv for k=7 on a larger map."""
    rng = np.random.default_rng(k)
    B, H, W, C = 2, 19, 23, 8
    x = rng.standard_normal((B, H, W, C))
    w_hwio = 0.1 * rng.standard_normal((k, k, 1, C))
    b = rng.standard_normal(C)
    w_torch = np.transpose(w_hwio, (3, 2, 0, 1))
    got = port_dwconv(t(x), t(w_torch), t(b)).numpy()
    with enable_x64():
        ref = np.asarray(jax_dwconv(jnp.asarray(x), jnp.asarray(w_hwio), jnp.asarray(b)))
    close(got, ref, rtol=1e-7, atol=1e-11)
    close(dwconv_kernel.depthwise_conv2d(t(x), t(w_torch), t(b)).numpy(), ref, atol=1e-11)
    close(dispatch.dwconv2d(t(x), t(w_torch), t(b)).numpy(), ref, atol=1e-11)


@pytest.mark.parametrize("size", [((7, 9), (13, 4)), ((5, 5), (5, 11)), ((1, 6), (3, 6)),
                                  ((12, 16), (48, 64))])
def test_resize_matches_jax_f64(size):
    (h, w), (oh, ow) = size
    x = np.random.default_rng(h * w).standard_normal((2, h, w, 3))
    with enable_x64():
        ref = np.asarray(jax_resize(jnp.asarray(x), oh, ow))
    close(resize_bilinear_align_corners(t(x), oh, ow).numpy(), ref)


def test_nothing_off_the_cpu_falls_back(monkeypatch):
    """An unmasked tensor that is not on the CPU goes to the kernel or
    raises: the kernels take only CUDA tensors. A masked call takes the
    plain route on any device, chosen before any kernel wrapper is reached."""
    q = torch.empty(1, 4, 4, 8, device="meta")
    mask = torch.ones(1, 4, dtype=torch.bool, device="meta")

    def no_kernel(*args, **kwargs):
        raise AssertionError("a masked call reached a kernel wrapper")

    with monkeypatch.context() as m:
        m.setattr(attention_kernel, "linear_attention", no_kernel)
        out = dispatch.attention(q, q, q, q_mask=mask)
    assert out.device.type == "meta" and out.shape == q.shape and out.dtype == q.dtype
    with pytest.raises(ValueError):
        dispatch.attention(q, q, q)
    x = torch.empty(1, 8, 8, 4, device="meta")
    with pytest.raises(ValueError):
        dispatch.dwconv2d(x, torch.empty(4, 1, 7, 7, device="meta"))
