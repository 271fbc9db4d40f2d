"""The port's CUDA kernels against their plain versions on the card, at
small and ragged shapes, and the launch counts. Marked ``gpu``: each test
skips without a CUDA card. On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_port_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the card's machine
need not have; this file uses none of its fixtures.)
"""

import pytest
import torch

from chip_smoke import main_path_shapes, production_config
from cfpnet_torch import kernels
from cfpnet_torch.kernels import dwconv, fused_loftr, linear_attention
from cfpnet_torch.models.deltar import model_geometries
from cfpnet_torch.ops.attention import linear_attention as attention_plain
from cfpnet_torch.ops.dwconv import depthwise_conv2d as dwconv_plain
from cfpnet_torch.ops.loftr import LoFTRParams, loftr_apply
from test_torch_port_loftr_plan import BF16_CASES

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


ATTENTION_CALLED = [(1, 1200, 784, 4, 32), (1, 4800, 3136, 4, 16), (1, 19200, 12544, 4, 8)]


@pytest.mark.parametrize("N,L,S,H,D", [(3, 37, 5, 4, 4), (2, 70, 300, 8, 8), (1, 129, 1000, 4, 16),
                                       (5, 3, 2, 4, 32), (1, 4097, 9001, 4, 8)] + ATTENTION_CALLED + [
    # two rows with several cluster sums each; the most rows of the fused layer
    (2, 4800, 12544, 4, 8), (140, 144, 144, 8, 4),
    # one query, one key
    (1, 1, 1, 4, 8), (2, 1, 7, 4, 32), (3, 9, 1, 8, 16)])
def test_linear_attention_kernel(gen, N, L, S, H, D):
    q, k, v = _randn(gen, N, L, H, D), _randn(gen, N, S, H, D), _randn(gen, N, S, H, D)
    kernels.reset_launches()
    got = linear_attention.linear_attention(q, k, v)
    torch.cuda.synchronize()
    assert linear_attention.launches == 1
    _assert_close(got, attention_plain(q, k, v))


def test_linear_attention_unaligned_views(gen):
    """Contiguous views that start 4 bytes into their storage are copied to
    16-byte alignment, not read across it."""
    shape = (1, 300, 4, 8)
    q, k, v = (_randn(gen, 9600 + 1)[1:].view(shape) for _ in range(3))
    assert q.data_ptr() % 16 != 0
    _assert_close(linear_attention.linear_attention(q, k, v), attention_plain(q, k, v))


def test_linear_attention_repeats_bitwise(gen):
    """Fixed-order sums, no atomics: two calls on the same inputs are equal
    to the bit, at each main-path shape."""
    for N, L, S, H, D in ATTENTION_CALLED:
        q, k, v = _randn(gen, N, L, H, D), _randn(gen, N, S, H, D), _randn(gen, N, S, H, D)
        a = linear_attention.linear_attention(q, k, v)
        b = linear_attention.linear_attention(q, k, v)
        assert torch.equal(a, b)


def test_linear_attention_back_to_back(gen):
    """Twenty calls on one stream with distinct inputs and no sync between
    them, each checked afterwards: an apply pass, started early, reads the
    cluster sums only after its own summary pass has ended."""
    calls = []
    for i in range(20):
        N, L, S, H, D = (ATTENTION_CALLED + [(140, 144, 144, 8, 4), (2, 70, 300, 8, 8)])[i % 5]
        calls.append((_randn(gen, N, L, H, D), _randn(gen, N, S, H, D), _randn(gen, N, S, H, D)))
    torch.cuda.synchronize()
    outs = [linear_attention.linear_attention(q, k, v) for q, k, v in calls]
    torch.cuda.synchronize()
    for (q, k, v), got in zip(calls, outs):
        _assert_close(got, attention_plain(q, k, v))


@pytest.mark.parametrize("N,L,S,H,D", ATTENTION_CALLED + [(140, 144, 144, 8, 4)])
def test_linear_attention_two_device_kernels_a_call(gen, N, L, S, H, D):
    """At most two device kernels a call, by name (torch.profiler)."""
    from chip_smoke import kernel_split

    q, k, v = _randn(gen, N, L, H, D), _randn(gen, N, S, H, D), _randn(gen, N, S, H, D)
    split = kernel_split(lambda: linear_attention.linear_attention(q, k, v))
    assert sum(s["launches"] for s in split.values()) <= 2, split
    assert all("attention_" in name for name in split), split


@pytest.mark.parametrize("B,H,W,C,k", [
    (1, 30, 40, 128, 7), (2, 17, 33, 12, 15), (1, 5, 70, 32, 31), (1, 120, 160, 32, 31),
    # maps that are no multiple of the tile, at each k
    (1, 61, 83, 32, 31), (1, 59, 81, 64, 15), (1, 31, 45, 128, 7), (1, 1, 3, 8, 31),
    # C no multiple of the channels a block (12 and 36 channels)
    (1, 23, 37, 36, 31), (2, 13, 19, 36, 7), (1, 60, 80, 12, 15),
    # the bs=2 entry point at the k=31 main-path shape
    (2, 120, 160, 32, 31)])
def test_dwconv_kernel(gen, B, H, W, C, k):
    x, w, b = _randn(gen, B, H, W, C), 0.05 * _randn(gen, C, 1, k, k), _randn(gen, C)
    kernels.reset_launches()
    got = dwconv.depthwise_conv2d(x, w, b)
    torch.cuda.synchronize()
    assert dwconv.launches == 1
    _assert_close(got, dwconv_plain(x, w, b))
    _assert_close(dwconv.depthwise_conv2d(x, w), dwconv_plain(x, w))


def test_dwconv_back_to_back(gen):
    """Twenty calls at the three main-path shapes on one stream, with
    distinct inputs and no sync between them, each checked afterwards."""
    calls = []
    for i in range(20):
        B, H, W, C, k = [(1, 120, 160, 32, 31), (1, 60, 80, 64, 15), (1, 30, 40, 128, 7)][i % 3]
        calls.append((_randn(gen, B, H, W, C), 0.05 * _randn(gen, C, 1, k, k), _randn(gen, C)))
    torch.cuda.synchronize()
    outs = [dwconv.depthwise_conv2d(x, w, b) for x, w, b in calls]
    torch.cuda.synchronize()
    for (x, w, b), got in zip(calls, outs):
        _assert_close(got, dwconv_plain(x, w, b))


def test_dwconv_refuses_channels_not_a_multiple_of_4(gen):
    """The kernel reads 16-byte groups of 4 channels; other C raise."""
    for C in (6, 33):
        x, w = _randn(gen, 1, 9, 10, C), _randn(gen, C, 1, 7, 7)
        with pytest.raises(ValueError, match="multiple of 4"):
            dwconv.depthwise_conv2d(x, w)


def test_kernels_refuse_what_they_do_not_take(gen):
    q = _randn(gen, 1, 8, 4, 8)
    with pytest.raises(TypeError):
        linear_attention.linear_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError):
        linear_attention.linear_attention(_randn(gen, 1, 8, 4, 6), _randn(gen, 1, 8, 4, 6),
                                          _randn(gen, 1, 8, 4, 6))
    qg = q.clone().requires_grad_()  # a gradient is no refusal: the kernel forward runs
    kernels.reset_launches()
    linear_attention.linear_attention(qg, q, q).sum().backward()
    assert linear_attention.launches == 1 and qg.grad is not None
    x = _randn(gen, 1, 8, 8, 4)
    with pytest.raises(ValueError):
        dwconv.depthwise_conv2d(x, _randn(gen, 4, 1, 9, 9))
    with pytest.raises(ValueError):
        dwconv.depthwise_conv2d(x.permute(0, 2, 1, 3), _randn(gen, 4, 1, 7, 7))


@pytest.mark.parametrize("N,L,S,H,D", [(2, 70, 300, 8, 8), (3, 37, 5, 4, 4),
                                       (16, 884, 576, 4, 32), (2, 3536, 2304, 4, 16)])
def test_linear_attention_backward(gen, N, L, S, H, D):
    """dq, dk, dv through the autograd.Function (kernel forward, backward
    recomputed from the plain version) against plain autograd; one launch."""
    ins = [_randn(gen, N, L, H, D).requires_grad_(), _randn(gen, N, S, H, D).requires_grad_(),
           _randn(gen, N, S, H, D).requires_grad_()]
    g = _randn(gen, N, L, H, D)
    kernels.reset_launches()
    got = torch.autograd.grad(linear_attention.linear_attention(*ins), ins, g)
    assert linear_attention.launches == 1
    for a, b in zip(got, torch.autograd.grad(attention_plain(*ins), ins, g)):
        _assert_close(a, b)


@pytest.mark.parametrize("B,H,W,C,k", [(2, 17, 33, 12, 15), (1, 5, 70, 32, 31), (3, 26, 34, 128, 7),
                                       (1, 104, 136, 32, 31), (4, 52, 68, 64, 15)])
def test_dwconv_backward(gen, B, H, W, C, k):
    """dx (the kernel on the rotated taps), dW (``torch.nn.grad.conv2d_weight``)
    and db against plain autograd; a forward and its backward launch the
    kernel twice."""
    ins = [_randn(gen, B, H, W, C).requires_grad_(),
           (0.05 * _randn(gen, C, 1, k, k)).requires_grad_(), _randn(gen, C).requires_grad_()]
    g = _randn(gen, B, H, W, C)
    kernels.reset_launches()
    got = torch.autograd.grad(dwconv.depthwise_conv2d(*ins), ins, g)
    torch.cuda.synchronize()
    assert dwconv.launches == 2
    for a, b in zip(got, torch.autograd.grad(dwconv_plain(*ins), ins, g)):
        _assert_close(a, b)


def test_dwconv_backward_of_a_strided_gradient(gen):
    """An upstream gradient that is not contiguous (a permuted view) is made
    contiguous before the kernel takes it."""
    x = _randn(gen, 2, 9, 11, 8).requires_grad_()
    w = 0.05 * _randn(gen, 8, 1, 7, 7)
    g = _randn(gen, 2, 11, 9, 8).transpose(1, 2)
    (dx,) = torch.autograd.grad(dwconv.depthwise_conv2d(x, w), (x,), g)
    _assert_close(dx, dwconv_plain(g.contiguous(), w.flip(-1, -2)))


def test_train_step_small_geometry(gen):
    """Two production train steps of the production-width model at the tiny
    config's geometry (train 48x64 of native 64x96, 2x2 zones), bs 2, on the
    card: each launches 3 attention, 3 + 3 dwconv and 9 fused-LoFTR kernels;
    the first step's loss matches the same step on the CPU (plain versions)
    to 1e-4, and the parameters move."""
    from cfpnet_torch import weights
    from cfpnet_torch.bench import smoke_config
    from cfpnet_torch.evaluate_time import make_train_batch
    from cfpnet_torch.models.deltar import make_model
    from cfpnet_torch.train import steps

    config = smoke_config().replace(tiny_model=False, mode="train", bs=2, input_height=48,
                                    input_width=64, train_zone_num=2, train_patch_px=16,
                                    disable_clip_grad=True, hist_encoder_10x=True)
    geoms = model_geometries(config, "train")
    losses = {}
    for device in ("cpu", "cuda"):
        model = make_model(config, device=device)
        model.load_state_dict(weights.deterministic_state_dict(config), strict=True)
        state = steps.create_train_state(model, config, 100)
        step = steps.make_train_step(model, config, geoms)
        batch = make_train_batch(config, 2, device)
        before = model.decoder.conv0.weight.detach().clone()
        kernels.reset_launches()
        losses[device] = [float(step(state, batch, 7))]
        if device == "cuda":
            assert (linear_attention.launches, dwconv.launches, fused_loftr.launches) == (3, 6, 9)
        losses[device].append(float(step(state, batch, 8)))
        assert not torch.equal(model.decoder.conv0.weight.detach(), before)
    assert all(torch.isfinite(torch.tensor(v)).all() for v in losses.values())
    torch.testing.assert_close(losses["cuda"][0], losses["cpu"][0], rtol=1e-4, atol=0)


def _loftr_params(gen, C, requires_grad=False):
    """Weights at the scale of tests/test_pallas_loftr.py::make_params, stored
    as nn.Linear stores them ([out, in]) and handed over as .t() views."""
    def leaf(*shape, mean=0.0):
        return (mean + 0.1 * _randn(gen, *shape)).requires_grad_(requires_grad)

    stored = dict(wq=leaf(C, C), wk=leaf(C, C), wv=leaf(C, C), wm=leaf(C, C), g1=leaf(C, mean=1.0),
                  b1=leaf(C), w0=leaf(2 * C, 2 * C), w1=leaf(C, 2 * C), g2=leaf(C, mean=1.0),
                  b2=leaf(C))
    return stored, LoFTRParams(**{k: v.t() if v.dim() == 2 else v for k, v in stored.items()})


# the nine LoFTR-layer shapes of the 480x640 forward
MAIN_PATH_LOFTR = sorted(main_path_shapes(production_config(),
                                          model_geometries(production_config(), "online_eval"))[2])


@pytest.mark.parametrize("N,L,S,C,H", [
    (1, 1, 1, 32, 4), (3, 37, 5, 32, 8), (5, 1, 9, 64, 4), (7, 19, 1, 64, 8), (13, 23, 17, 128, 8),
    (1, 4097, 130, 32, 8), (2, 4097, 130, 128, 4), (3, 50, 200, 128, 8),
    # fewer row tiles than resident clusters at C = 128 (N*L = 1 and 17)
    (1, 1, 5, 128, 8), (1, 17, 9, 128, 4),
    # row tiles that do not divide among the resident clusters or blocks
    (3, 1111, 40, 128, 8), (1, 4321, 7, 64, 4), (2, 9001, 3, 32, 8),
    # group boundaries inside a row tile, at every C
    (9, 7, 3, 128, 8), (6, 13, 11, 64, 4), (11, 21, 7, 32, 8)] + MAIN_PATH_LOFTR)
def test_fused_loftr_kernel(gen, N, L, S, C, H):
    x, src = _randn(gen, N, L, C), _randn(gen, N, S, C)
    _, p = _loftr_params(gen, C)
    kernels.reset_launches()
    got = fused_loftr.fused_loftr(x, src, p, H)
    torch.cuda.synchronize()
    assert fused_loftr.launches == 1
    _assert_close(got, loftr_apply(x, src, p, H))


def test_fused_loftr_back_to_back(gen):
    """Twenty calls on one stream with distinct inputs and no sync between
    them, each checked afterwards: the row pass reads kv only after the
    summary pass has ended, and scratch that the caching allocator hands
    from one call to the next is never read stale."""
    calls = []
    for i in range(20):
        N, L, S, C, H = [(1, 1200, 30, 128, 8), (35, 36, 36, 128, 8), (64, 49, 16, 64, 4),
                         (1, 4800, 48, 64, 8), (140, 144, 144, 32, 8)][i % 5]
        _, p = _loftr_params(gen, C)
        calls.append((_randn(gen, N, L, C), _randn(gen, N, S, C), p, H))
    torch.cuda.synchronize()
    outs = [fused_loftr.fused_loftr(x, src, p, H) for x, src, p, H in calls]
    torch.cuda.synchronize()
    for (x, src, p, H), got in zip(calls, outs):
        _assert_close(got, loftr_apply(x, src, p, H))


def test_fused_loftr_backward(gen):
    """Gradients through the autograd.Function (kernel forward) equal plain
    autograd of loftr_apply on the card, for x, source and every weight."""
    N, L, S, C, H = 3, 20, 11, 64, 8
    x0, src0, g = _randn(gen, N, L, C), _randn(gen, N, S, C), _randn(gen, N, L, C)
    grads = []
    for fn in (fused_loftr.fused_loftr, loftr_apply):
        gen.manual_seed(5)
        stored, p = _loftr_params(gen, C, requires_grad=True)
        x, src = x0.clone().requires_grad_(), src0.clone().requires_grad_()
        fn(x, src, p, H).backward(g)
        grads.append([x.grad, src.grad] + [w.grad for w in stored.values()])
    for got, ref in zip(*grads):
        _assert_close(got, ref)


def test_fused_loftr_refuses_what_it_does_not_take(gen):
    x, src = _randn(gen, 2, 8, 32), _randn(gen, 2, 5, 32)
    _, p = _loftr_params(gen, 32)
    with pytest.raises(TypeError):
        fused_loftr.fused_loftr(x.double(), src.double(), LoFTRParams(*(w.double() for w in p)), 4)
    with pytest.raises(ValueError):
        fused_loftr.fused_loftr(_randn(gen, 2, 32, 8).transpose(1, 2), src, p, 4)
    with pytest.raises(ValueError):
        fused_loftr.fused_loftr(x, src, p._replace(wq=p.wq.contiguous()), 4)
    _, p48 = _loftr_params(gen, 48)
    with pytest.raises(ValueError):
        fused_loftr.fused_loftr(_randn(gen, 2, 8, 48), _randn(gen, 2, 5, 48), p48, 4)
    with pytest.raises(ValueError):
        fused_loftr.fused_loftr(x, src, p, 2)


def _captured_model():
    """The production-width model (C = 128 / 64 / 32, which the kernels take;
    the tiny model's 16 and 8 they do not) at the tiny test config's 64x96
    geometry, on the golden tests' deterministic weights, and sample inputs
    at bs=8."""
    from cfpnet_torch.bench import smoke_config
    from cfpnet_torch.evaluate_time import load_model

    config = smoke_config().replace(tiny_model=False)
    model = load_model(config)
    gen = torch.Generator(device="cuda").manual_seed(3)
    Z = config.eval_zone_num ** 2
    inputs = (torch.randn(8, 64, 96, 3, device="cuda", generator=gen),
              2.0 * torch.rand(8, Z, config.zone_sample_num, device="cuda", generator=gen),
              torch.rand(8, Z, device="cuda", generator=gen) > 0.25)
    return config, model, model_geometries(config, "online_eval"), inputs


def _eager(model, inputs, geoms):
    with torch.no_grad():
        return model(*inputs, geoms)[:3]


def _assert_equal(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a, b), float((a - b).abs().max())


def test_captured_forward_replays_the_eager_forward(gen):
    """The replay equals the eager forward bit for bit; new inputs after the
    capture give new outputs, again equal to their eager forward."""
    from cfpnet_torch.graphs import CapturedForward

    config, model, geoms, inputs = _captured_model()
    captured = CapturedForward(model, geoms, 1, config)
    first = [t.clone() for t in captured(*(a[:1] for a in inputs))[:3]]
    _assert_equal(first, _eager(model, [a[:1] for a in inputs], geoms))
    second = captured(*(a[1:2] for a in inputs))[:3]
    assert not torch.equal(first[1], second[1])
    _assert_equal(second, _eager(model, [a[1:2] for a in inputs], geoms))


def test_captured_forward_is_bitwise_stable(gen):
    """100 replays on the same inputs give the same bits."""
    from cfpnet_torch.graphs import CapturedForward

    config, model, geoms, inputs = _captured_model()
    captured = CapturedForward(model, geoms, 1, config)
    want = [t.clone() for t in captured(*(a[:1] for a in inputs))[:3]]
    for _ in range(100):
        got = captured.replay()[:3]
    _assert_equal(got, want)


def test_captured_forward_rows_match_bs1(gen):
    """At bs=8 the eager pass launches 6/6/18 and each row of the replay
    matches the bs=1 forward of its sample (rtol 5e-4, atol 5e-5, the
    golden's tolerance: the convolutions' sums change with the batch)."""
    from cfpnet_torch.graphs import CapturedForward

    config, model, geoms, inputs = _captured_model()
    kernels.reset_launches()
    _eager(model, inputs, geoms)
    assert (linear_attention.launches, dwconv.launches, fused_loftr.launches) == (3, 3, 9)
    captured = CapturedForward(model, geoms, 8, config)
    got = captured(*inputs)[:3]
    for i in range(8):
        for a, b in zip(got, _eager(model, [x[i:i + 1] for x in inputs], geoms)):
            torch.testing.assert_close(a[i:i + 1], b, rtol=5e-4, atol=5e-5)


def test_captured_forward_refuses(gen):
    """Inputs of other shapes or dtypes raise; so does a model on the CPU."""
    from cfpnet_torch.graphs import CapturedForward

    config, model, geoms, inputs = _captured_model()
    captured = CapturedForward(model, geoms, 1, config)
    with pytest.raises(ValueError):
        captured(*inputs)
    with pytest.raises(ValueError):
        captured(inputs[0][:1].double(), inputs[1][:1], inputs[2][:1])
    with pytest.raises(ValueError):
        CapturedForward(model.cpu(), geoms, 1, config)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_artifact_on_the_card(gen, dtype, tmp_path):
    """The production-width model at 64x96 exported for the card at bs 1 and
    2: each program calls the three custom ops 3 / 3 / 9 times, an eager
    call of its module launches the kernels, and ``predict`` of 3 rows
    (chunked 2 + 1, each replayed from a CUDA graph) equals the live eval
    step at those batch sizes bit for bit."""
    from cfpnet_torch import weights
    from cfpnet_torch.models.deltar import cast_to_compute_dtype
    from cfpnet_torch.serve.export import ServingModel, custom_op_calls, export_serving_artifact
    from cfpnet_torch.train.steps import make_eval_step

    config, model, geoms, inputs = _captured_model()
    export_serving_artifact(config, weights.deterministic_state_dict(config), str(tmp_path),
                            batch_sizes=(1, 2), compute_dtype=dtype, device="cuda")
    m = ServingModel(str(tmp_path), "cuda")
    image = (inputs[0][:3].clamp(-2, 2) * 60 + 128).to(torch.uint8)
    hist, mask = inputs[1][:3], inputs[2][:3]
    for bs in (1, 2):
        assert custom_op_calls(m.exported(bs)) == {
            "cfpnet::linear_attention": 3, "cfpnet::dwconv2d": 3, "cfpnet::fused_loftr": 9}
        kernels.reset_launches()
        with torch.no_grad():
            m.module(bs)(image[:bs], hist[:bs], mask[:bs])
        assert (linear_attention.launches, dwconv.launches, fused_loftr.launches) == (3, 3, 9)
    got = m.predict(image.cpu().numpy(), hist.cpu().numpy(), mask.cpu().numpy())
    cast_to_compute_dtype(model, getattr(torch, dtype))
    step = make_eval_step(model, config, geoms, protocol="validate",
                          compute_dtype=getattr(torch, dtype))
    for rows in (slice(0, 2), slice(2, 3)):
        want = step({"image_u8": image[rows], "hist_data": hist[rows], "mask": mask[rows]})[0]
        assert (got[rows] == want[..., 0].cpu().numpy()).all()


# bf16 variants: max |kernel - plain| <= 2^-7 max |plain|, one bf16 ulp at the
# top of the range (kernel and plain version round at the same points; their
# f32 sums run in another order, so a value near a rounding boundary may land
# one ulp apart)
BF16_TOL = 2.0 ** -7
MAIN_PATH_DWCONV = [(1, 30, 40, 128, 7), (1, 60, 80, 64, 15), (1, 120, 160, 32, 31)]


def _assert_close_bf16(got, ref):
    assert got.dtype == ref.dtype == torch.bfloat16
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    assert err <= BF16_TOL * float(ref.abs().max()), err


@pytest.mark.parametrize("N,L,S,H,D", ATTENTION_CALLED + [(3, 37, 5, 4, 4), (140, 144, 144, 8, 4)])
def test_linear_attention_kernel_bf16(gen, N, L, S, H, D):
    q, k, v = (_randn(gen, N, n, H, D).bfloat16() for n in (L, S, S))
    kernels.reset_launches()
    got = linear_attention.linear_attention(q, k, v)
    torch.cuda.synchronize()
    assert linear_attention.launches == 1
    _assert_close_bf16(got, attention_plain(q, k, v))


@pytest.mark.parametrize("B,H,W,C,k", MAIN_PATH_DWCONV + [(2, 17, 33, 12, 15)])
def test_dwconv_kernel_bf16(gen, B, H, W, C, k):
    x, w, b = _randn(gen, B, H, W, C), 0.05 * _randn(gen, C, 1, k, k), _randn(gen, C)
    x, w, b = x.bfloat16(), w.bfloat16(), b.bfloat16()
    kernels.reset_launches()
    got = dwconv.depthwise_conv2d(x, w, b)
    torch.cuda.synchronize()
    assert dwconv.launches == 1
    _assert_close_bf16(got, dwconv_plain(x, w, b))


def _loftr_params_bf16(gen, C):
    stored, _ = _loftr_params(gen, C)
    stored = {k: v.bfloat16() for k, v in stored.items()}
    return LoFTRParams(**{k: v.t() if v.dim() == 2 else v for k, v in stored.items()})


@pytest.mark.parametrize("N,L,S,C,H", MAIN_PATH_LOFTR + [(3, 37, 5, 32, 8), (1, 17, 9, 128, 4)])
def test_fused_loftr_kernel_bf16(gen, N, L, S, C, H):
    x, src = _randn(gen, N, L, C).bfloat16(), _randn(gen, N, S, C).bfloat16()
    p = _loftr_params_bf16(gen, C)
    kernels.reset_launches()
    got = fused_loftr.fused_loftr(x, src, p, H)
    torch.cuda.synchronize()
    assert fused_loftr.launches == 1
    _assert_close_bf16(got, loftr_apply(x, src, p, H))


@pytest.mark.parametrize("N,L,S,C,H", BF16_CASES)
def test_fused_loftr_bf16_cases(gen, N, L, S, C, H):
    """The bf16 kernel at every (C, D), both tile heights, a split summary
    and not, summary blocks over several groups and ragged row tiles
    (``BF16_CASES``) against its plain version; a second call on the same
    inputs equal bit for bit."""
    x, src = _randn(gen, N, L, C).bfloat16(), _randn(gen, N, S, C).bfloat16()
    p = _loftr_params_bf16(gen, C)
    kernels.reset_launches()
    got = fused_loftr.fused_loftr(x, src, p, H)
    torch.cuda.synchronize()
    assert fused_loftr.launches == 1
    _assert_close_bf16(got, loftr_apply(x, src, p, H))
    assert torch.equal(fused_loftr.fused_loftr(x, src, p, H), got)


def test_fused_loftr_bf16_plan_within_the_card(gen):
    """Each bf16 row variant's resident clusters in launch_plan are at most
    what the card's occupancy query gives, so a grid of them runs at once."""
    for C, variants in fused_loftr.ROW_VARIANTS_BF16.items():
        for D in (C // 4, C // 8):
            for tm, cl in variants:
                planned = fused_loftr._row_units(C, D, tm, cl, torch.bfloat16)[2]
                card = fused_loftr.resident(C, D, tm, cl)
                print(f"C={C} D={D} tm={tm} cl={cl}: planned {planned}, card {card}")
                assert planned <= card


def test_fused_loftr_bf16_refuses_unaligned_weights(gen):
    """The bf16 kernel's TMA and 16-byte loads need 16-byte aligned weights:
    a view 8 bytes off is refused, never computed by another path."""
    x = _randn(gen, 2, 8, 32).bfloat16()
    p = _loftr_params_bf16(gen, 32)
    storage = torch.zeros(32 * 32 + 4, device="cuda", dtype=torch.bfloat16)
    wq = storage[4:].view(32, 32)
    wq.copy_(p.wq.t())
    with pytest.raises(ValueError, match="16 bytes"):
        fused_loftr.fused_loftr(x, x, p._replace(wq=wq.t()), 4)


@pytest.mark.parametrize("kernel,shape", [("linear_attention", (16, 884, 576, 4, 32)),
                                          ("dwconv", (16, 26, 34, 128, 7)),
                                          ("fused_loftr", (576, 16, 16, 128, 4))])
def test_bf16_backward_at_a_train_shape(gen, kernel, shape):
    """Each kernel's bf16 gradients at one shape of the bf16 train step
    against autograd of its bf16 plain twin, in bf16, one forward launch
    (dwconv: and one more for dx)."""
    bf16 = torch.bfloat16
    if kernel == "linear_attention":
        N, L, S, H, D = shape
        ins = [_randn(gen, N, n, H, D).to(bf16).requires_grad_() for n in (L, S, S)]
        fn, plain, want = linear_attention.linear_attention, attention_plain, 1
        g = _randn(gen, N, L, H, D).to(bf16)
    elif kernel == "dwconv":
        B, H, W, C, k = shape
        ins = [_randn(gen, B, H, W, C).to(bf16).requires_grad_(),
               (0.05 * _randn(gen, C, 1, k, k)).to(bf16).requires_grad_(),
               _randn(gen, C).to(bf16).requires_grad_()]
        fn, plain, want = dwconv.depthwise_conv2d, dwconv_plain, 2
        g = _randn(gen, B, H, W, C).to(bf16)
    else:
        N, L, S, C, H = shape
        stored, _ = _loftr_params(gen, C)
        stored = {k: v.to(bf16).requires_grad_() for k, v in stored.items()}
        p = LoFTRParams(**{k: v.t() if v.dim() == 2 else v for k, v in stored.items()})
        ins = [_randn(gen, N, L, C).to(bf16).requires_grad_(),
               _randn(gen, N, S, C).to(bf16).requires_grad_(), *stored.values()]
        fn = lambda x, s, *_: fused_loftr.fused_loftr(x, s, p, H)  # noqa: E731
        plain = lambda x, s, *_: loftr_apply(x, s, p, H)  # noqa: E731
        want, g = 1, _randn(gen, N, L, C).to(bf16)
    kernels.reset_launches()
    got = torch.autograd.grad(fn(*ins), ins, g)
    torch.cuda.synchronize()
    assert launches_of(kernel) == {"bfloat16": want}
    for a, b in zip(got, torch.autograd.grad(plain(*ins), ins, g)):
        _assert_close_bf16(a, b)


def launches_of(kernel):
    return dict({"linear_attention": linear_attention, "dwconv": dwconv,
                 "fused_loftr": fused_loftr}[kernel].launches_by_dtype)


def _small_train(compute_dtype="bfloat16"):
    """The production-width model at the tiny config's geometry (train
    48x64 of native 64x96, 2x2 zones), bs 2, the deterministic weights:
    (model, state, step, batch) of ``train/steps.py`` on the card."""
    from cfpnet_torch import weights
    from cfpnet_torch.bench import smoke_config
    from cfpnet_torch.evaluate_time import make_train_batch
    from cfpnet_torch.models.deltar import make_model
    from cfpnet_torch.train import steps

    config = smoke_config().replace(tiny_model=False, mode="train", bs=2, input_height=48,
                                    input_width=64, train_zone_num=2, train_patch_px=16,
                                    disable_clip_grad=True, hist_encoder_10x=True,
                                    compute_dtype=compute_dtype)
    geoms = model_geometries(config, "train")
    model = make_model(config, device="cuda")
    model.load_state_dict(weights.deterministic_state_dict(config), strict=True)
    state = steps.create_train_state(model, config, 100)
    return model, state, steps.make_train_step(model, config, geoms), make_train_batch(
        config, 2, "cuda")


def test_bf16_train_step_launches_only_bf16_kernels(gen):
    """One production bf16 train step at the small geometry: 3 attention,
    3 + 3 dwconv and 9 fused-LoFTR launches, every one on bf16 tensors; a
    finite loss; the parameters move and stay float32."""
    model, state, step, batch = _small_train()
    before = model.decoder.conv0.weight.detach().clone()
    kernels.reset_launches()
    loss = step(state, batch, 7)
    torch.cuda.synchronize()
    assert {k: launches_of(k) for k in ("linear_attention", "dwconv", "fused_loftr")} == {
        "linear_attention": {"bfloat16": 3}, "dwconv": {"bfloat16": 6},
        "fused_loftr": {"bfloat16": 9}}
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert not torch.equal(model.decoder.conv0.weight.detach(), before)
    assert {p.dtype for p in model.parameters()} == {torch.float32}


def test_bf16_train_steps_repeat_bitwise(gen):
    """Two bf16 steps from the same state, each on its own copy of the
    model, under deterministic algorithms: the same loss, parameters,
    statistics and moments, bit for bit."""
    from chip_smoke import deterministic_algorithms, flat_state

    got = []
    with deterministic_algorithms():
        for _ in range(2):
            model, state, step, batch = _small_train()
            loss = step(state, batch, 7)
            got.append((loss, *flat_state(state)))
    (loss_a, flat_a, step_a), (loss_b, flat_b, step_b) = got
    assert torch.equal(loss_a, loss_b) and step_a == step_b == 1
    assert flat_a.keys() == flat_b.keys()
    assert [k for k in flat_a if not torch.equal(flat_a[k], flat_b[k])] == []


def test_kernels_refuse_mixed_dtypes(gen):
    q = _randn(gen, 1, 8, 4, 8)
    with pytest.raises(TypeError):
        linear_attention.linear_attention(q.bfloat16(), q, q)
    x = _randn(gen, 1, 9, 10, 4)
    with pytest.raises(TypeError):
        dwconv.depthwise_conv2d(x.bfloat16(), 0.05 * _randn(gen, 4, 1, 7, 7))
    x = _randn(gen, 2, 8, 32)
    with pytest.raises(TypeError):
        fused_loftr.fused_loftr(x.bfloat16(), x.bfloat16(), _loftr_params(gen, 32)[1], 4)


def test_captured_forward_bf16(gen):
    """The bf16 model (``cast_to_compute_dtype``) captured at bs=1: the replay
    equals the eager bf16 forward bit for bit, an eager pass launches 3/3/9
    kernels, and f32 inputs are refused."""
    from cfpnet_torch.graphs import CapturedForward
    from cfpnet_torch.models.deltar import cast_to_compute_dtype

    config, model, geoms, inputs = _captured_model()
    cast_to_compute_dtype(model, torch.bfloat16)
    one = [inputs[0][:1].bfloat16(), inputs[1][:1].bfloat16(), inputs[2][:1]]
    kernels.reset_launches()
    want = _eager(model, one, geoms)
    assert (linear_attention.launches, dwconv.launches, fused_loftr.launches) == (3, 3, 9)
    captured = CapturedForward(model, geoms, 1, config)
    _assert_equal(captured(*one)[:3], want)
    with pytest.raises(ValueError):
        captured(inputs[0][:1], inputs[1][:1], inputs[2][:1])


@pytest.mark.parametrize("scale", [16, 8, 4])
def test_masked_calls_take_the_plain_route(gen, scale):
    """Masked attention and a masked LoFTR layer at each bs=1 hist2image
    shape, in f32 and bf16: the plain route on the card within
    ``chip_smoke.MASKED_TOL`` of the CPU in float64, no kernel launched;
    the same calls unmasked launch their kernels."""
    from chip_smoke import masked_calls

    out = masked_calls("cuda", scale)
    for dtype in ("float32", "bfloat16"):
        assert not any(out[dtype]["launches_masked"].values())
        assert out[dtype]["launches_unmasked"] == {"linear_attention": 1, "dwconv": 0,
                                                   "fused_loftr": 1}


@pytest.mark.parametrize("name", ["baseline", "fusion_names"])
def test_config_forward_launches(gen, name):
    """A forward of the DELTAR baseline's and of the fusion names' layers
    (production widths at the 64x96 geometry) launches
    ``chip_smoke.CONFIG_LAUNCHES``: 0 / 0 / 18 and 9 / 12 / 9."""
    from chip_smoke import CONFIG_LAUNCHES, FUSION_NAMES
    from cfpnet_torch.bench import smoke_config
    from cfpnet_torch.evaluate_time import load_model

    layers = {"baseline": ["hist2image", "image", "hist2image", "image"],
              "fusion_names": list(FUSION_NAMES)}[name]
    config = smoke_config().replace(tiny_model=False, attention_layer=layers)
    model = load_model(config)
    _, _, geoms, inputs = _captured_model()
    kernels.reset_launches()
    out = _eager(model, [a[:1] for a in inputs], geoms)
    torch.cuda.synchronize()
    assert torch.isfinite(out[1]).all()
    assert {k.__name__.rsplit(".", 1)[-1]: k.launches for k in kernels.KERNELS} == \
        CONFIG_LAUNCHES[name]
