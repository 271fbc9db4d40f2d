"""The port's CUDA kernels against their plain versions on the card, at
small and ragged shapes, and the launch counts. Marked ``gpu``: each test
skips without a CUDA card. On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_port_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the card's machine
need not have; this file uses none of its fixtures.)
"""

import pytest
import torch

from cfpnet_torch import kernels
from cfpnet_torch.kernels import dwconv, linear_attention
from cfpnet_torch.ops.attention import linear_attention as attention_plain
from cfpnet_torch.ops.dwconv import depthwise_conv2d as dwconv_plain

pytestmark = pytest.mark.gpu

TOL = 1e-4  # max |kernel - plain| / max |plain|: the sums run in another order


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape):
    return torch.randn(*shape, device="cuda", generator=gen)


def _assert_close(got, ref):
    err = float((got - ref).abs().max())
    assert err <= TOL * float(ref.abs().max()), err


@pytest.mark.parametrize("N,L,S,H,D", [(3, 37, 5, 4, 4), (2, 70, 300, 8, 8), (1, 129, 1000, 4, 16),
                                       (5, 3, 2, 4, 32), (1, 4097, 9001, 4, 8)])
def test_linear_attention_kernel(gen, N, L, S, H, D):
    q, k, v = _randn(gen, N, L, H, D), _randn(gen, N, S, H, D), _randn(gen, N, S, H, D)
    kernels.reset_launches()
    got = linear_attention.linear_attention(q, k, v)
    torch.cuda.synchronize()
    assert linear_attention.launches == 1
    _assert_close(got, attention_plain(q, k, v))


@pytest.mark.parametrize("B,H,W,C,k", [(1, 30, 40, 128, 7), (2, 17, 33, 12, 15),
                                       (1, 5, 70, 32, 31), (1, 120, 160, 32, 31)])
def test_dwconv_kernel(gen, B, H, W, C, k):
    x, w, b = _randn(gen, B, H, W, C), 0.05 * _randn(gen, C, 1, k, k), _randn(gen, C)
    kernels.reset_launches()
    got = dwconv.depthwise_conv2d(x, w, b)
    torch.cuda.synchronize()
    assert dwconv.launches == 1
    _assert_close(got, dwconv_plain(x, w, b))
    _assert_close(dwconv.depthwise_conv2d(x, w), dwconv_plain(x, w))


def test_kernels_refuse_what_they_do_not_take(gen):
    q = _randn(gen, 1, 8, 4, 8)
    with pytest.raises(TypeError):
        linear_attention.linear_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError):
        linear_attention.linear_attention(_randn(gen, 1, 8, 4, 6), _randn(gen, 1, 8, 4, 6),
                                          _randn(gen, 1, 8, 4, 6))
    qg = q.clone().requires_grad_()
    with pytest.raises(NotImplementedError):
        linear_attention.linear_attention(qg, q, q)
    x = _randn(gen, 1, 8, 8, 4)
    with pytest.raises(ValueError):
        dwconv.depthwise_conv2d(x, _randn(gen, 4, 1, 9, 9))
    with pytest.raises(ValueError):
        dwconv.depthwise_conv2d(x.permute(0, 2, 1, 3), _randn(gen, 4, 1, 7, 7))
