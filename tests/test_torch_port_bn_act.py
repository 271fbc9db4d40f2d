"""The eval-mode BatchNorm epilogue kernel (``kernels/bn_act.py``,
``csrc/bn_act.cu``) and BatchNorm's route to it.

On the CPU: every call that is not an eval call on a CUDA tensor needing no
gradient takes the plain route, bit for bit the formula BatchNorm wrote out
before the kernel existed, then the activation, then the shortcut; the
wrapper refuses what the kernel does not take; the launch plan, and the
channel each lane of the kernel reads, recomputed here from the kernel's
arithmetic (``fast_div``, the PLANE split, the TOKENS lanes), cover every
element once with its own channel at the main path's shapes; and the
production-width forwards make 122 (CFPNet) and 104 (DELTAR baseline)
BatchNorm calls, the launches the card must show. The route of a CUDA
call (``ops/dispatch.py::batch_norm``), and the raise of an eval call on
the card that the kernel does not take, are checked on fake CUDA tensors
(``FakeTensorMode``), which need no card.

Marked ``gpu`` (skip without a card): the kernel against its plain twin at
every call a CFPNet and a DELTAR eval forward make (collected by a hook),
in f32 and bf16, each activation, with and without the shortcut, and at
ragged shapes; the launches of a captured forward and of a train step. On
the card:

    python -m pytest --noconftest -m gpu tests/test_torch_port_bn_act.py

This file imports no JAX.
"""

import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import bn_calls
from cfpnet_torch import tracing
from cfpnet_torch.kernels import bn_act
from cfpnet_torch.models.layers import BatchNorm, frozen_running_stats
from cfpnet_torch.ops import dispatch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"cfpnet": "configs/train_cfpnet_combine1.txt",
           "deltar": "configs/train_deltar_baseline.txt"}
BN_CALLS = {"cfpnet": 122, "deltar": 104}  # BatchNorm calls of one eval forward
ACTIVATIONS = {"identity": lambda y: y, "silu": F.silu,
               "leaky_relu": lambda y: F.leaky_relu(y, 0.01), "relu": F.relu}
DTYPES = (torch.float32, torch.bfloat16)


def parent_formula(x, weight, bias, mean, var, eps, act, channel_dim, residual):
    """BatchNorm's eval output, then the caller's activation and shortcut,
    as the model computed them before the kernel: ``BatchNorm._normalize``,
    ``F.silu`` / ``F.leaky_relu(0.01)`` / ``F.relu``, ``+ x``."""
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    mul = torch.rsqrt(var + eps) * weight
    y = (x - mean.view(shape)) * mul.view(shape) + bias.view(shape)
    y = y.to(torch.promote_types(torch.promote_types(x.dtype, weight.dtype), bias.dtype))
    y = ACTIVATIONS[act](y)
    return y if residual is None else y + residual


def _params(C, dtype, gen, device="cpu"):
    """weight, bias, mean, var of C channels (var in [0.5, 1.5])."""
    def draw(f):
        return f(torch.randn(C, generator=gen)).to(device, dtype)
    return (draw(lambda t: 1 + 0.3 * t), draw(lambda t: 0.2 * t), draw(lambda t: 0.5 * t),
            draw(lambda t: 1 + t.tanh() / 2))


def _module(C, channel_dim, dtype, gen, device="cpu"):
    bn = BatchNorm(C, 1e-3, channel_dim=channel_dim).to(device)
    w, b, m, v = _params(C, torch.float32, gen, device)
    with torch.no_grad():
        bn.weight.copy_(w), bn.bias.copy_(b), bn.running_mean.copy_(m), bn.running_var.copy_(v)
    return bn.to(dtype)


# --- CPU: the plain route ---------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("act", bn_act.ACTS)
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "shortcut"])
@pytest.mark.parametrize("channel_dim,shape", [(1, (2, 24, 5, 7)), (-1, (3, 11, 40))],
                         ids=["nchw", "tokens"])
def test_cpu_eval_is_the_parent_formula(dtype, act, residual, channel_dim, shape):
    """An eval call on the CPU equals the parent's written-out formula bit for
    bit, and launches nothing."""
    gen = torch.Generator().manual_seed(1)
    C = shape[channel_dim]
    bn = _module(C, channel_dim, dtype, gen).eval()
    x = torch.randn(shape, generator=gen).to(dtype)
    r = torch.randn(shape, generator=gen).to(dtype) if residual else None
    tracing.reset_counters("kernel.")
    with torch.no_grad():
        got = bn(x, act, r)
    want = parent_formula(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps, act,
                          channel_dim, r)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert tracing.counters("kernel.bn_act.") == {}


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("act", bn_act.ACTS)
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "shortcut"])
def test_cpu_train_is_the_parent_formula(dtype, act, residual):
    """A training call on the CPU: the batch's statistics into the parent's
    formula, bit for bit, the same gradients as the formula's, the running
    statistics moved as before."""
    gen = torch.Generator().manual_seed(2)
    bn = _module(6, 1, dtype, gen).train()
    twin = _module(6, 1, dtype, torch.Generator().manual_seed(2)).train()
    x = torch.randn(2, 6, 4, 5, generator=gen).to(dtype).requires_grad_()
    r = torch.randn(2, 6, 4, 5, generator=gen).to(dtype) if residual else None
    got = bn(x, act, r)
    mean, var = twin._batch_stats(x)
    want = parent_formula(x, twin.weight, twin.bias, mean, var, twin.eps, act, 1, r)
    assert torch.equal(got, want)
    gy = torch.randn(got.shape, generator=gen).to(dtype)
    g_got = torch.autograd.grad(got, (x, bn.weight, bn.bias), gy)
    g_want = torch.autograd.grad(want, (x, twin.weight, twin.bias), gy)
    assert all(torch.equal(a, b) for a, b in zip(g_got, g_want))
    assert torch.equal(bn.running_mean, twin.running_mean)
    assert torch.equal(bn.running_var, twin.running_var)


def test_plain_twin_is_the_parent_formula():
    """``bn_act_plain`` on f32 statistics with bf16 x, weight and bias (a bf16
    train step's call) rounds as the parent did and gives bf16."""
    gen = torch.Generator().manual_seed(3)
    w, b, m, v = _params(8, torch.float32, gen)
    x = torch.randn(2, 8, 3, 3, generator=gen).bfloat16()
    args = (x, w.bfloat16(), b.bfloat16(), m, v, 1e-5, "silu", 1, None)
    got = bn_act.bn_act_plain(*args)
    assert got.dtype == torch.bfloat16 and torch.equal(got, parent_formula(*args))


# --- CPU: the wrapper -------------------------------------------------------

def _call_args(x, gen, act="relu", channel_dim=1, residual=None):
    w, b, m, v = _params(x.shape[channel_dim], x.dtype, gen)
    return (x, w, b, m, v, 1e-5, act, channel_dim, residual)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_wrapper_on_the_cpu_is_the_plain_twin(dtype):
    """The op on CPU tensors (contiguous, and an NCHW map in channels-last
    memory with a shortcut in the same layout) is the plain twin, bit for
    bit, and counts no launch."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 16, 5, 6, generator=gen).to(dtype)
    cl = x.contiguous(memory_format=torch.channels_last)
    tracing.reset_counters("kernel.")
    for args in (_call_args(x, gen), _call_args(cl, gen, "silu", 1, cl * 0.5)):
        got = bn_act.bn_act(*args)
        assert torch.equal(got, bn_act.bn_act_plain(*args))
        assert got.stride() == args[0].stride()
    assert tracing.counters("kernel.bn_act.") == {}


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Non-contiguous x, a shortcut of another layout, mixed element types,
    another dtype, a wrong parameter shape or activation, and a tensor on a
    device that is neither the CPU nor a card raise, on the CPU too."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 8, 6, 6, generator=gen)
    with pytest.raises(ValueError, match="contiguous"):
        bn_act.bn_act(*_call_args(x[..., ::2], gen))
    with pytest.raises(ValueError, match="contiguous"):
        bn_act.bn_act(*_call_args(x.transpose(0, 1), gen))
    with pytest.raises(ValueError, match="residual"):
        bn_act.bn_act(*_call_args(x, gen, residual=x.contiguous(
            memory_format=torch.channels_last)))
    args = list(_call_args(x, gen))
    args[1] = args[1].bfloat16()
    with pytest.raises(TypeError):
        bn_act.bn_act(*args)
    with pytest.raises(TypeError):
        bn_act.bn_act(*_call_args(x, gen, residual=x.bfloat16()))
    with pytest.raises(TypeError):
        bn_act.bn_act(*_call_args(x.double(), gen))
    args = list(_call_args(x, gen))
    args[3] = args[3][:4]
    with pytest.raises(ValueError, match="mean"):
        bn_act.bn_act(*args)
    with pytest.raises(ValueError, match="act"):
        bn_act.bn_act(*_call_args(x, gen, act="gelu"))
    with pytest.raises(ValueError):
        bn_act.bn_act(*_call_args(x.to("meta"), gen))


# --- CPU: the route of a CUDA call, on fake CUDA tensors --------------------

@pytest.fixture
def fake_cuda(monkeypatch):
    """A fake-tensor mode in which ``torch.device("cuda")`` tensors exist
    without a card, and the list of calls that reached the kernel's wrapper
    (the wrapper itself runs its fake implementation)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    calls = []
    wrapper = bn_act.bn_act

    def counted(*args):
        calls.append(args)
        return wrapper(*args)

    monkeypatch.setattr(bn_act, "bn_act", counted)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        yield mode, calls


def _fake_module(channel_dim=1, dtype=torch.float32):
    """A BatchNorm of 8 channels on the fake card, its parameters and
    statistics in ``dtype`` (set one by one: ``Module.to`` cannot swap fake
    parameters)."""
    with torch.device("cuda"):
        bn = BatchNorm(8, 1e-3, channel_dim=channel_dim)
    for name, p in list(bn.named_parameters()):
        setattr(bn, name, torch.nn.Parameter(p.detach().to(dtype)))
    for name, b in list(bn.named_buffers()):
        setattr(bn, name, b.to(dtype))
    return bn


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_eval_cuda_call_without_gradient_takes_the_kernel(fake_cuda, dtype):
    """Eval mode, a CUDA tensor, grad mode off (the captured forward) or no
    tensor requiring a gradient: one call of the kernel's wrapper, with the
    activation and the shortcut; a channels-last map too."""
    _, calls = fake_cuda
    bn = _fake_module(dtype=dtype).eval()
    x = torch.empty(1, 8, 4, 5, device="cuda", dtype=dtype)
    with torch.no_grad():
        bn(x, "silu", x)
    for p in bn.parameters():
        p.requires_grad_(False)
    bn(torch.empty_strided((2, 8, 4, 5), (160, 1, 40, 8), device="cuda", dtype=dtype), "relu")
    tokens = _fake_module(-1, dtype).eval()
    with torch.no_grad():
        tokens(torch.empty(3, 7, 8, device="cuda", dtype=dtype), "leaky_relu")
    assert [(c[6], c[7], c[8] is not None) for c in calls] == [
        ("silu", 1, True), ("relu", 1, False), ("leaky_relu", -1, False)]


def test_training_and_gradient_calls_take_the_plain_route(fake_cuda):
    """Training mode (with or without grad mode) and a call needing a
    gradient (grad mode on and a parameter, the input or the shortcut
    requiring one) take the written-out formula, not the kernel; grad mode
    off, or nothing requiring a gradient, takes the kernel. (The calls that
    need a gradient are routed, not run: autograd cannot record on fake CUDA
    tensors without a CUDA build, so both wrappers are replaced by
    recorders.)"""
    _, calls = fake_cuda
    bn = _fake_module()
    x = torch.empty(2, 8, 4, 5, device="cuda")
    with torch.no_grad(), frozen_running_stats():  # no in-place update of fake statistics
        bn.train()
        bn(x, "silu", x)
    assert calls == []

    def route(x, residual=None, training=False):
        taken = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(bn_act, "bn_act", lambda *a: taken.append("kernel"))
            mp.setattr(bn_act, "bn_act_plain", lambda *a: taken.append("plain"))
            dispatch.batch_norm(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, 1e-3,
                                "silu", 1, residual, training)
        return taken == ["kernel"]

    assert not route(x, training=True)
    assert not route(x)  # the parameters require a gradient
    with torch.no_grad():
        assert route(x) and not route(x, training=True)
    for p in bn.parameters():
        p.requires_grad_(False)
    assert route(x, x)
    assert not route(x.clone().requires_grad_())
    assert not route(x, x.clone().requires_grad_())


def test_eval_cuda_calls_the_kernel_refuses_raise(fake_cuda):
    """An eval call on the card that needs no gradient goes to the kernel
    whatever its layout and dtypes, and raises there on what the kernel does
    not take: a layout it does not read, a shortcut of another layout, mixed
    element types. Nothing falls back to the written-out formula."""
    _, calls = fake_cuda
    bn = _fake_module().eval()
    x = torch.empty(2, 8, 4, 5, device="cuda")
    with torch.no_grad():
        with pytest.raises(ValueError, match="contiguous"):
            bn(torch.empty_strided((2, 8, 4, 3), (160, 20, 5, 2), device="cuda"))  # x[..., ::2]
        with pytest.raises(TypeError):
            bn(torch.empty(x.shape, device="cuda", dtype=torch.bfloat16))
        with pytest.raises(ValueError, match="residual"):
            bn(x, "relu", torch.empty_strided(x.shape, (160, 1, 40, 8), device="cuda"))
    assert len(calls) == 3


# --- CPU: the launch plan and the kernel's channel arithmetic ---------------

def test_fast_div_is_exact():
    """``fast_div``'s multiply and shift give n // d at every divisor the
    main path uses (C and inner) and at the extremes of 0 <= n < 2^31."""
    rng = np.random.default_rng(0)
    ns = np.concatenate([np.arange(5000), rng.integers(0, 2 ** 31, 20000),
                         2 ** 31 - 1 - np.arange(200)]).astype(object)
    for d in [1, 2, 3, 7, 8, 16, 32, 40, 56, 112, 136, 232, 300, 1200, 1392, 4800, 19200,
              76800, 2 ** 30 + 1, 2 ** 31 - 1]:
        mul, shift = bn_act.fast_div(d)
        assert 0 <= mul < 2 ** 32
        got = ns if d == 1 else ((ns * mul) >> 32) >> shift
        assert (got == ns // d).all(), d


def kernel_channels(n, C, inner, vec, plan):
    """The channel the kernel gives each of n elements (-1 where no thread
    writes it; a count above 1 where several do), recomputed from
    csrc/bn_act.cu's arithmetic: FastDiv quotients, the PLANE split of a
    vector at its plane's end, the TOKENS lanes c .. c + vec - 1, one
    channel an element for SCALAR and the tail."""
    im, ishift = bn_act.fast_div(inner)
    cm, cshift = bn_act.fast_div(C)

    def quot(e, d, m, s):
        return e if d == 1 else ((e * m) >> 32) >> s

    def channel_of(e):
        q = quot(e, inner, im, ishift)
        return q - quot(q, C, cm, cshift) * C

    got = np.full(n, -1, np.int64)
    writes = np.zeros(n, np.int64)
    items = plan["items"]
    threads = plan["blocks"] * bn_act.THREADS
    assert threads >= items + (1 if plan["tail"] else 0)
    if plan["mode"] == "scalar":
        e = np.arange(items, dtype=np.int64)
        got[e] = channel_of(e)
        writes[e] += 1
        return got, writes
    e0 = np.arange(items, dtype=np.int64) * vec
    lanes = np.arange(vec, dtype=np.int64)
    if plan["mode"] == "plane":
        q = quot(e0, inner, im, ishift)
        c = q - quot(q, C, cm, cshift) * C
        split = inner - (e0 - q * inner)
        nxt = np.where(c + 1 == C, 0, c + 1)
        ch = np.where(lanes[None, :] < split[:, None], c[:, None], nxt[:, None])
    else:
        c = e0 - quot(e0, C, cm, cshift) * C
        ch = c[:, None] + lanes[None, :]
    idx = (e0[:, None] + lanes[None, :]).ravel()
    got[idx] = ch.ravel()
    np.add.at(writes, idx, 1)
    tail = np.arange(items * vec, n, dtype=np.int64)
    assert len(tail) == plan["tail"] < vec
    got[tail] = channel_of(tail)
    writes[tail] += 1
    return got, writes


# (shape, channel_dim, channels-last) of the eval forward's BatchNorm calls at
# 480x640 (the hook of ``bn_calls``, on the CPU), and ragged ones
LAYOUTS = [((1, 1392, 15, 20), 1, True), ((1, 40, 240, 320), 1, True),
           ((1, 32, 240, 320), 1, False), ((1, 256, 30, 40), 1, False),
           ((1, 232, 15, 20), 1, False), ((1, 120, 160, 32), -1, False), ((64, 16, 128), -1, False),
           ((3, 5, 7, 9), 1, False), ((2, 12, 3, 3), 1, False), ((5, 36), -1, False),
           ((2, 20, 3, 1), 1, True), ((1, 3, 301, 1), 1, False)]


@pytest.mark.parametrize("shape,channel_dim,cl", LAYOUTS)
@pytest.mark.parametrize("vec", [4, 8], ids=["f32", "bf16"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
def test_every_element_gets_its_channel_once(shape, channel_dim, cl, vec, aligned):
    """At each layout, f32 and bf16 vectors, aligned or not: the plan's
    threads write every element exactly once, each with its own channel
    (e // inner) mod C."""
    x = torch.empty(shape, device="meta")
    if cl:
        x = x.contiguous(memory_format=torch.channels_last)
    C, inner = bn_act.memory_layout(x, channel_dim)
    n = x.numel()
    plan = bn_act.launch_plan(n, C, inner, vec, aligned)
    if not aligned or (inner < vec and not (inner == 1 and C % vec == 0)):
        assert plan["mode"] == "scalar"
    got, writes = kernel_channels(n, C, inner, vec, plan)
    assert (writes == 1).all()
    e = np.arange(n, dtype=np.int64)
    assert (got == (e // inner) % C).all()


def test_memory_layout():
    """(C, inner) in memory: NCHW planes, channel-innermost tokens, an NCHW
    map in channels-last memory; None where the kernel cannot read x."""
    x = torch.empty(2, 8, 5, 6, device="meta")
    assert bn_act.memory_layout(x, 1) == (8, 30)
    assert bn_act.memory_layout(x.contiguous(memory_format=torch.channels_last), 1) == (8, 1)
    assert bn_act.memory_layout(torch.empty(3, 7, 16, device="meta"), -1) == (16, 1)
    assert bn_act.memory_layout(x[:, :, ::2], 1) is None
    assert bn_act.memory_layout(x.permute(0, 2, 3, 1), -1) is None


def test_bytes_moved():
    assert bn_act.bytes_moved(1000, 10, 2, False) == 2 * (2000 + 40)
    assert bn_act.bytes_moved(1000, 10, 4, True) == 4 * (3000 + 40)


# --- the BatchNorm calls of a forward ----------------------------------------

def production_model(name, device, dtype=torch.float32, small=False):
    """The benchmark configuration ``name``'s model (its config file; with
    ``small``, its layers at production widths on the tiny config's 64x96
    geometry) on the deterministic weights, cast to ``dtype``, its bs=1 eval
    inputs and geometries, and the config."""
    from cfpnet_torch import weights
    from cfpnet_torch.bench import smoke_config
    from cfpnet_torch.config import parse_config
    from cfpnet_torch.models.deltar import cast_to_compute_dtype, make_model, model_geometries

    config = parse_config([f"@{os.path.join(ROOT, CONFIGS[name])}"]).replace(mode="online_eval")
    if small:
        config = smoke_config().replace(tiny_model=False, attention_layer=config.attention_layer)
    geoms = model_geometries(config, "online_eval")
    model = make_model(config, device=device)
    model.load_state_dict(weights.deterministic_state_dict(config), strict=True)
    cast_to_compute_dtype(model, dtype)
    gen = torch.Generator().manual_seed(7)
    Z = config.eval_zone_num ** 2
    inputs = (torch.randn(1, config.native_height, config.native_width, 3, generator=gen),
              2.0 * torch.rand(1, Z, config.zone_sample_num, generator=gen),
              torch.rand(1, Z, generator=gen) > 0.25)
    inputs = tuple(t.to(device) if t.dtype == torch.bool else t.to(device, dtype) for t in inputs)
    return model, inputs, geoms, config


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_makes_the_expected_batchnorm_calls(name):
    """A production-width eval forward (at 64x96 here) calls BatchNorm 122
    times (CFPNet) or 104 (DELTAR): the launches one forward must show on the
    card; every call's layout is one the kernel reads and its shortcut has
    x's layout."""
    model, inputs, geoms, _ = production_model(name, "cpu", small=True)
    calls = bn_calls(model, *inputs, geoms)
    assert len(calls) == BN_CALLS[name]
    for x, act, residual, m in calls:
        assert bn_act.refusal(x, m.weight, m.bias, m.running_mean, m.running_var, act,
                              m.channel_dim, residual) is None
    assert {act for _, act, _, _ in calls} == set(bn_act.ACTS)
    assert sum(r is not None for _, _, r, _ in calls) == 26


def test_grid_forward_normalizes_once_a_shard(monkeypatch):
    """On a 1 x 2 grid of row shards (``--spatial_shards``) the CFPNet eval
    forward normalizes 217 times, once a shard in the row-sharded modules:
    the bn_act launches ``chip_smoke.GRID_EVAL_LAUNCHES`` expects of its
    phase 18 on the card."""
    from chip_smoke import GRID_EVAL_LAUNCHES
    from cfpnet_torch.parallel import spatial

    model, (img, hist, mask), geoms, _ = production_model("cfpnet", "cpu", small=True)
    calls = []
    normalize = BatchNorm._normalize

    def counted(self, *args, **kwargs):
        calls.append(self)
        return normalize(self, *args, **kwargs)

    grid = spatial.make_mesh_2d(1, 2, ["cpu"] * 2)
    placed = spatial.shard_batch_spatial(dict(image=img, hist_data=hist, mask=mask), grid)
    monkeypatch.setattr(BatchNorm, "_normalize", counted)
    with torch.no_grad():
        model(placed["image"], placed["hist_data"], placed["mask"], geoms, grid=grid)
    assert len(calls) == GRID_EVAL_LAUNCHES["bn_act"]
    assert len(set(map(id, calls))) == BN_CALLS["cfpnet"]


# --- on the card ---------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator().manual_seed(0)


_CARD_CALLS = {}


def card_calls():
    """The distinct (shape, strides, channel_dim) of the BatchNorm calls of a
    CFPNet and a DELTAR eval forward at 480x640 on the card, f32, by hook."""
    if not _CARD_CALLS:
        for name in sorted(CONFIGS):
            model, inputs, geoms, _ = production_model(name, "cuda")
            calls = bn_calls(model, *inputs, geoms)
            assert len(calls) == BN_CALLS[name]
            for x, _, _, m in calls:
                _CARD_CALLS[(tuple(x.shape), x.stride(), m.channel_dim)] = None
            del model
    return list(_CARD_CALLS)


def _on_card(shape, stride, channel_dim, dtype, gen, residual):
    """x (and a shortcut) of ``shape`` and ``stride`` on the card, and the
    four parameters."""
    def tensor():
        t = torch.empty_strided(shape, stride, device="cuda", dtype=dtype)
        t.copy_(3 * torch.randn(shape, generator=gen))
        return t
    return tensor(), (tensor() if residual else None), _params(shape[channel_dim], dtype, gen,
                                                                 "cuda")


def _errors(x, r, params, channel_dim, act, eps=1e-3):
    """(kernel, plain twin) outputs and their worst errors against the f32
    formula on the same inputs."""
    args = (x, *params, eps, act, channel_dim, r)
    tracing.reset_counters("kernel.")
    got = bn_act.bn_act(*args)
    torch.cuda.synchronize()
    assert sum(tracing.counters("kernel.bn_act.").values()) == 1
    plain = bn_act.bn_act_plain(*args)
    f32 = bn_act.bn_act_plain(*(a.float() if isinstance(a, torch.Tensor) else a for a in args))
    assert got.dtype == x.dtype and got.stride() == plain.stride()
    return got, plain, float((got.float() - f32).abs().max()), float(
        (plain.float() - f32).abs().max()), float(f32.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("act", bn_act.ACTS)
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "shortcut"])
def test_kernel_at_the_forwards_calls(card, dtype, act, residual):
    """At every (shape, layout, channel_dim) of the two eval forwards: in f32
    within 1e-6 of the plain twin relative to its largest value; in bf16 no
    farther from the f32 formula than the plain bf16 twin."""
    for shape, stride, channel_dim in card_calls():
        x, r, params = _on_card(shape, stride, channel_dim, dtype, card, residual)
        got, plain, err, plain_err, top = _errors(x, r, params, channel_dim, act)
        if dtype == torch.float32:
            assert float((got - plain).abs().max()) <= 1e-6 * float(plain.abs().max()), shape
        else:
            assert err <= plain_err, (shape, err, plain_err)


RAGGED = [((2, 24, 15, 20), None, 1), ((1, 8, 30, 40), None, 1), ((3, 5, 7, 9), None, 1),
          ((2, 12, 3, 3), None, 1), ((5, 36), None, -1), ((7, 3, 40), None, -1),
          ((1, 1392, 15, 20), "cl", 1), ((2, 20, 3, 1), "cl", 1), ((1, 3, 301, 1), None, 1),
          ((4, 16, 61, 1), None, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,layout,channel_dim", RAGGED)
def test_kernel_at_ragged_shapes(card, dtype, shape, layout, channel_dim):
    """Planes that are not whole vectors (vectors straddling channels), odd C,
    planes narrower than a vector, a tail past the last vector, and views 4
    bytes into their storage (SCALAR): each activation, with and without the
    shortcut."""
    x = torch.randn(shape, generator=card).to("cuda", dtype)
    if layout == "cl":
        x = x.contiguous(memory_format=torch.channels_last)
    views = [x]
    if layout is None:  # a contiguous view 2 elements (4 or 8 bytes) into its storage
        views.append(torch.randn(x.numel() + 2, generator=card).to("cuda", dtype)[2:].view(shape))
    for x in views:
        for act in bn_act.ACTS:
            for residual in (False, True):
                r = x * 0.5 + 1 if residual else None
                params = _params(shape[channel_dim], dtype, card, "cuda")
                got, plain, err, plain_err, _ = _errors(x, r, params, channel_dim, act)
                if dtype == torch.float32:
                    assert float((got - plain).abs().max()) <= 1e-6 * float(plain.abs().max())
                else:
                    assert err <= plain_err


@pytest.mark.gpu
def test_kernel_refuses_off_the_card(card):
    """On the card the op refuses a tensor on another device than x and a
    layout it does not read, as on the CPU."""
    x = torch.randn(1, 8, 4, 4, device="cuda")
    w, b, m, v = _params(8, torch.float32, card, "cuda")
    with pytest.raises(ValueError):
        bn_act.bn_act(x, w.cpu(), b, m, v, 1e-3)
    with pytest.raises(ValueError):
        bn_act.bn_act(x[..., ::2], w, b, m, v, 1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_captured_forward_launches_one_kernel_a_batchnorm(card, name, dtype):
    """The 480x640 eval forward captured in a CUDA graph holds 122 (CFPNet) or
    104 (DELTAR) bn_act launches, and each replay counts them; the replay
    equals the eager forward bit for bit."""
    from cfpnet_torch.graphs import CapturedForward
    from cfpnet_torch.kernels.dtypes import dtype_name

    model, inputs, geoms, config = production_model(name, "cuda", dtype)
    captured = CapturedForward(model, geoms, 1, config)
    assert captured.launches[f"kernel.bn_act.launches.{dtype_name(dtype)}"] == BN_CALLS[name]
    tracing.reset_counters("kernel.")
    for _ in range(3):
        captured.replay()
    torch.cuda.synchronize()
    assert sum(tracing.counters("kernel.bn_act.").values()) == 3 * BN_CALLS[name]
    got = [t.clone() for t in captured(*inputs)[:3]]
    with torch.no_grad():
        want = model(*inputs, geoms)[:3]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
def test_train_step_launches_no_bn_act(card):
    """A production train step at a small geometry takes the plain route in
    every BatchNorm: 0 bn_act launches."""
    from cfpnet_torch.bench import smoke_config
    from cfpnet_torch.evaluate_time import make_train_batch
    from cfpnet_torch.models.deltar import make_model, model_geometries
    from cfpnet_torch.train import steps

    config = smoke_config().replace(tiny_model=False, mode="train", bs=2, input_height=48,
                                    input_width=64, train_zone_num=2, train_patch_px=16,
                                    disable_clip_grad=True, hist_encoder_10x=True)
    model = make_model(config, device="cuda")
    state = steps.create_train_state(model, config, 100)
    step = steps.make_train_step(model, config, model_geometries(config, "train"))
    tracing.reset_counters("kernel.")
    loss = step(state, make_train_batch(config, 2, "cuda"), 7)
    torch.cuda.synchronize()
    assert math.isfinite(float(loss))
    assert tracing.counters("kernel.bn_act.") == {}
    assert sum(tracing.counters("kernel.fused_loftr.").values()) > 0
