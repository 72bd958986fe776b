"""K3's stage on the CPU (ops/post_pqmf.py): the post net, the multiband
gains and the PQMF synthesis as one op, `mbexwn::post_pqmf`.

`post_pqmf_plain` against the model's former three steps
(`Conv1DWeightNorm` -> `* mb_gain[:, :T]` -> `pqmf_synthesis`) within 1e-6
rel-RMS, on SPEECH's bank (6 bands, 94 taps) and a 64-channel post net:
weight norm, the equalized-LR post gain, no bias, a multiband gain, a
partial synthesis (`max_band` 4), T = 1, 2, 50 (a live span), 6,400, batch
1 and 3.  The op on CPU tensors is the plain version and launches nothing;
it takes x in rows or, as the WaveNet's end conv leaves it, channel-major;
its fake implementation gives the shape and dtype, so `torch.export` traces
one node for the stage; the wrapper raises on what K3 does not take; the op
has no backward pass.  K3 itself is held against the plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from mbexwn_vocoder_torch.dsp.pqmf import pqmf_filters
from mbexwn_vocoder_torch.nn.layers import Conv1DWeightNorm
from mbexwn_vocoder_torch.ops import kernel_lib
from mbexwn_vocoder_torch.ops.post_pqmf import post_pqmf, post_pqmf_plain
from mbexwn_vocoder_torch.ops.pqmf_ops import pqmf_synthesis

torch.set_num_threads(2)
S, TAPS, CIN = 6, 94, 64

VARIANTS = {
    "weight_norm": dict(),
    "equalized_lr_post_gain": dict(equalized_lr=True),
    "no_bias": dict(bias=False),
    "multiband_gain": dict(mb_gain=True),
    "max_band_4": dict(max_band=4),
    "max_band_4_multiband_gain": dict(max_band=4, mb_gain=True),
}


def _case(B, T, equalized_lr=False, bias=True, mb_gain=False, max_band=None):
    """A seeded post net (64 -> 6), its input, a multiband gain with more
    rows than T (the model slices it) or None, and the synthesis bank."""
    g = torch.Generator().manual_seed(1000 * B + T)
    post = Conv1DWeightNorm(CIN, S, 1, use_weight_norm=not equalized_lr, use_equalized_lr=equalized_lr,
                            use_bias=bias, name="wn_post_net")
    post.init(g)
    with torch.no_grad():
        if bias:
            post.bias.copy_(0.1 * torch.randn(S, generator=g))
        if equalized_lr:
            post.g.copy_(1.0 + 0.2 * torch.randn(S, generator=g))
    x = 0.5 * torch.randn(B, T, CIN, generator=g)
    mb = torch.exp(0.3 * torch.randn(B, T + 7, S, generator=g)) if mb_gain else None
    _, syn = pqmf_filters(S, TAPS, 0.0945, 9.0, max_band)
    return post, x, mb, torch.from_numpy(np.ascontiguousarray(syn.transpose(2, 1, 0))), max_band


def _args(post, mb, filt):
    """The op's arguments after x, as the model hands them."""
    kernel, bias, gain = (None if t is None else t.detach() for t in post.conv_args())
    return kernel[:, :, 0], bias, gain, mb, filt, S, filt.shape[1]


def _rel(a, b):
    return float(torch.sqrt(torch.mean((a - b) ** 2) / torch.mean(b ** 2)))


@pytest.fixture
def no_kernel_build(monkeypatch):
    """A CPU path must never build or launch a kernel."""
    def refuse():
        raise AssertionError("a CPU tensor reached the CUDA kernel library")
    monkeypatch.setattr(kernel_lib, "library", refuse)
    before = dict(kernel_lib.launches)
    yield
    assert kernel_lib.launches == before


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("T", [1, 2, 50, 6400])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_matches_the_three_steps(no_kernel_build, variant, T, B):
    """post_pqmf_plain within 1e-6 rel-RMS of wn_post_net -> * mb_gain ->
    pqmf_synthesis; the op on CPU tensors gives the plain version's output."""
    post, x, mb, filt, max_band = _case(B, T, **VARIANTS[variant])
    with torch.no_grad():
        y = post(x)
        if mb is not None:
            y = y * mb[:, :T]
        ref = pqmf_synthesis(y, filt, S, TAPS, max_band)[:, :, 0]
        got = post_pqmf_plain(x, *_args(post, mb, filt))
        op = post_pqmf(x, *_args(post, mb, filt))
    assert got.shape == op.shape == (B, T * S) and got.dtype == op.dtype == torch.float32
    assert _rel(got, ref) <= 1e-6 and torch.equal(op, got)


@pytest.mark.parametrize("B,T", [(1, 1), (3, 50), (8, 51_200)])
def test_fake_gives_shape_and_dtype(B, T):
    """The op's fake implementation: (B, T * S) fp32, without computing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    post, _, _, filt, _ = _case(1, 1)
    real = _args(post, None, filt)
    with FakeTensorMode() as mode:
        x = torch.empty(B, T, CIN)
        fakes = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in real]
        out = torch.ops.mbexwn.post_pqmf(x, *fakes)
    assert tuple(out.shape) == (B, T * S) and out.dtype == torch.float32


def test_export_traces_one_node(no_kernel_build):
    """torch.export of a module that calls the op: one `mbexwn.post_pqmf`
    node in the graph, and the program's output is the plain version's."""
    post, x, mb, filt, _ = _case(2, 40, mb_gain=True)
    args = _args(post, mb, filt)

    class Stage(torch.nn.Module):
        def forward(self, x):
            return post_pqmf(x, *args)

    exported = torch.export.export(Stage(), (x,), strict=False)
    nodes = [n for n in exported.graph.nodes if "post_pqmf" in str(n.target)]
    assert len(nodes) == 1
    assert torch.equal(exported.module()(x), post_pqmf_plain(x, *args))


def _bf16_x(x, args):
    return (x.bfloat16(),) + args


def _strided_x(x, args):
    return (x[:, ::2],) + args


def _wrong_band_count(x, args):
    return (x,) + args[:4] + (args[4], S, 4)


def _short_mb_gain(x, args):
    return (x,) + args[:3] + (args[3][:, :10],) + args[4:]


def _weight_of_other_width(x, args):
    return (x, args[0][:, :32].contiguous()) + args[1:]


@pytest.mark.parametrize("edit,match", [(_bf16_x, "float32"), (_strided_x, "contiguous"),
                                        (_wrong_band_count, "used"), (_short_mb_gain, "mb_gain"),
                                        (_weight_of_other_width, "weight")],
                         ids=["bf16_x", "non_contiguous_x", "filter_band_count", "short_mb_gain", "weight_width"])
def test_wrapper_raises_on_what_k3_does_not_take(edit, match):
    post, x, mb, filt, _ = _case(2, 30, mb_gain=True)
    with pytest.raises(ValueError, match=match):
        post_pqmf(*edit(x, _args(post, mb, filt)))


@pytest.mark.parametrize("B,T", [(1, 50), (3, 50), (2, 1)])
def test_channel_major_x_is_taken_as_it_is(no_kernel_build, B, T):
    """x as the WaveNet's end conv leaves it, a (B, T, Cin) view of a
    contiguous (B, Cin, T): the wrapper takes it without a copy, and the
    stage's output is that of the same values in rows."""
    post, x, mb, filt, _ = _case(B, T, mb_gain=True)
    x_cm = x.transpose(1, 2).contiguous().transpose(1, 2)
    with torch.no_grad():
        assert torch.equal(post_pqmf(x_cm, *_args(post, mb, filt)), post_pqmf_plain(x, *_args(post, mb, filt)))


def test_the_op_has_no_backward_pass():
    """With grad on and an input that requires grad the op raises; the plain
    version, which the training route runs, gives the post net a gradient."""
    post, x, _, filt, _ = _case(1, 20)
    weight = post.kernel()[:, :, 0]
    with pytest.raises(RuntimeError, match="no backward pass"):
        post_pqmf(x, weight, post.bias, None, None, filt, S, S)
    post_pqmf_plain(x, weight, post.bias, None, None, filt, S, S).square().sum().backward()
    assert post.weight.grad is not None and float(post.weight.grad.abs().sum()) > 0
