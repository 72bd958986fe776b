"""Tensor parallelism on the CPU: a model built with MBEXWN_TP_AXIS=model,
placed on a mesh's "model" axis of CPU devices, splits each WaveNet
stack's hidden channels over them (parallel/tensor.py).

The port of tests/test_parallel.py::test_tensor_parallel_wavenet (SPEECH
with a 16-channel, 2-layer WaveNet, the noise channel off, no mel
normalisation; JAX's init, folded, loaded into the port) on
`devices=["cpu"] * 4`: meshes of 2 x 2 and 1 x 4, held against JAX's
unsharded `infer` (1e-4 rel-RMS) and against the port unsharded (1e-5).
Beside it: one tiny fp64 gradient through the differentiable route under
tensor parallelism against the unsharded stack (1e-12), `BatchSynthesizer`
over a 2-D mesh, the weights replicated when the variable is not set, the
int8 mode under tensor parallelism (each layer against the unsharded int8
layer on the same inputs, 1e-5; the whole synthesis against JAX's int8
within 0.1 x JAX's own int8-against-fp distance, tests/test_torch_quant.py's
rule), streaming's `synth_batched` over 2 x 2 and 1 x 2 grids (1e-5 from the
port at mesh=None, 1e-4 from JAX's at mesh=None on the same chunk
geometry), and what stays refused (channels that do not split).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mbexwn_vocoder_tpu as mv
from mbexwn_vocoder_tpu.config import read_config as jax_read_config
from mbexwn_vocoder_tpu.models import create_model as jax_create_model
from mbexwn_vocoder_tpu.ops.conv import fold_weight_norm as jax_fold
from mbexwn_vocoder_tpu.parallel import StreamingSynthesizer as JaxStreamingSynthesizer

from mbexwn_vocoder_torch import get_config_file
from mbexwn_vocoder_torch.compat.params_io import flatten, params_from_jax
from mbexwn_vocoder_torch.config import read_config
from mbexwn_vocoder_torch.models import create_model
from mbexwn_vocoder_torch.nn.layers import Conv1DWeightNorm
from mbexwn_vocoder_torch.nn.wavenet import WaveNetAE, int8_layer
from mbexwn_vocoder_torch.ops import quant
from mbexwn_vocoder_torch.parallel import BatchSynthesizer, StreamingSynthesizer, tensor
from mbexwn_vocoder_torch.parallel.mesh import make_mesh, replicate

from tests.test_torch_model import rel_rms

torch.set_num_threads(2)
SYNTH = 2400  # 8 mel frames


def _edit(hp):
    mc = hp["mbexwn_config"]
    mc["pp_mod_subnet"].update(n_channels=16, n_layers=2, n_out_channels=8)
    mc["normalize_rms_from_mell"] = False
    mc["pp_mod_subnet_noise_channel_sigma"] = 0.0
    return hp


@pytest.fixture(scope="module")
def jax_reference():
    """tests/test_parallel.py's model, its folded init and its unsharded
    synthesis of a batch-2 mel."""
    hp = _edit(jax_read_config(mv.get_config_file("SPEECH")))
    model, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
    params = jax_fold(model.init(jax.random.PRNGKey(0), batch_size=2, T_mel=8))
    mel = (np.random.RandomState(0).randn(2, 8, 80) * 0.5 - 4).astype(np.float32)
    return params, mel, np.asarray(model.infer(params, jnp.asarray(mel), synth_length=SYNTH))


def _port(params, monkeypatch, tp: bool):
    if tp:
        monkeypatch.setenv("MBEXWN_TP_AXIS", "model")
    else:
        monkeypatch.delenv("MBEXWN_TP_AXIS", raising=False)
    hp = _edit(read_config(get_config_file("SPEECH")))
    model = create_model(hp, hp["training_config"], hp["preprocess_config"])[0]
    model.block.load_state_dict(params_from_jax(flatten(params)), strict=True)
    return model.eval()


def _stacks(model):
    return [getattr(model.block, n).wavenet for n in model.block.block_names]


@pytest.mark.parametrize("n_data,n_model", [(2, 2), (1, 4)])
def test_tensor_parallel_matches_unsharded(jax_reference, monkeypatch, n_data, n_model):
    params, mel, ref = jax_reference
    plain = _port(params, monkeypatch, tp=False)
    with torch.no_grad():
        y_plain = plain.infer(torch.from_numpy(mel), synth_length=SYNTH).numpy()
    model = _port(params, monkeypatch, tp=True)
    mesh = make_mesh(n_data=n_data, n_model=n_model, devices=["cpu"] * 4)
    assert mesh.shape == {"data": n_data, "model": n_model}
    replica = replicate(model, mesh)[torch.device("cpu")]
    assert all(wn.tp_devices == (torch.device("cpu"),) * n_model and wn.route() == "layers"
               for wn in _stacks(replica))
    reduces = []
    reduce_add = tensor.reduce_add
    monkeypatch.setattr(tensor, "reduce_add", lambda p, home: reduces.append(len(p)) or reduce_add(p, home))
    with torch.no_grad():
        y_tp = replica.infer(torch.from_numpy(mel), synth_length=SYNTH).numpy()
    assert reduces == [n_model] * 4  # one reduce a layer, 2 layers in each of 2 blocks
    assert rel_rms(y_tp, ref) <= 1e-4, rel_rms(y_tp, ref)
    assert rel_rms(y_tp, y_plain) <= 1e-5, rel_rms(y_tp, y_plain)


def test_batch_synthesizer_over_a_2d_mesh(jax_reference, monkeypatch):
    """Batches over "data", channels over "model": equal to mesh=None to
    fp32 rounding."""
    params, _, _ = jax_reference
    model = _port(params, monkeypatch, tp=True)
    rng = np.random.RandomState(4)
    mells = [(rng.randn(T, 80) * 0.5 - 4).astype(np.float32) for T in (20, 35, 28, 20, 31)]
    ref = BatchSynthesizer(model, length_buckets=(32, 64), device="cpu").synth_batch(mells)
    bs = BatchSynthesizer(model, mesh=make_mesh(n_data=2, n_model=2, devices=["cpu"] * 4), length_buckets=(32, 64))
    assert bs.n_shards == 2 and all(wn.tp_devices is not None for wn in _stacks(bs.model))
    got = bs.synth_batch(mells)
    assert max(rel_rms(y, r) for y, r in zip(got, ref)) <= 1e-5


def test_model_axis_without_the_variable_replicates(jax_reference, monkeypatch):
    """A model built without MBEXWN_TP_AXIS keeps its weights replicated over
    the model axis: its stacks stay whole and on the kernel's route."""
    params, mel, _ = jax_reference
    model = _port(params, monkeypatch, tp=False)
    with torch.no_grad():
        ref = model.infer(torch.from_numpy(mel), synth_length=SYNTH)
    replica = replicate(model, make_mesh(n_model=2, devices=["cpu", "cpu"]))[torch.device("cpu")]
    assert all(wn.tp_devices is None and wn.route() == "k1" for wn in _stacks(replica))
    with torch.no_grad():
        assert torch.equal(replica.infer(torch.from_numpy(mel), synth_length=SYNTH), ref)


def _trainable_stack(dtype=torch.float64, **kw):
    net = WaveNetAE(5, 6, n_channels=12, n_layers=3, kernel_size=3, n_out_channels=4, max_log2_dilation_rate=7,
                    cond_kernel_size=3, cond_conv_upsampling=2, cond_lin_upsampling=4, tp_axis="model", **kw)
    gen = torch.Generator().manual_seed(0)
    for m in net.modules():
        if isinstance(m, Conv1DWeightNorm):
            m.trainable_()
            m.init(gen)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))  # nonzero biases
    net.differentiable = True
    return net.to(dtype)


@pytest.mark.parametrize("groups", [1, 2])
def test_fp64_gradient_under_tensor_parallelism(groups):
    """The differentiable route over 3 model devices: the loss and every
    parameter's gradient equal the unsharded stack's within 1e-12."""
    rng = np.random.RandomState(9)
    audio = torch.from_numpy(rng.randn(2, 96, 5) * 0.4)
    mel = torch.from_numpy(rng.randn(2, 12, 6) * 0.4)
    out = {}
    for sharded in (False, True):
        net = _trainable_stack(n_ch_groups=groups)
        if sharded:
            tensor.shard_model(net, ["cpu"] * 3)
            assert net.tp_devices == (torch.device("cpu"),) * 3
        loss = (net(audio, mel) ** 2).mean()
        loss.backward()
        out[sharded] = (loss.item(), {k: p.grad.clone() for k, p in net.named_parameters()})
    assert abs(out[True][0] - out[False][0]) <= 1e-12 * abs(out[False][0])
    for k, g in out[False][1].items():
        assert float((out[True][1][k] - g).norm() / g.norm()) <= 1e-12, k


def test_refusals(jax_reference, monkeypatch):
    """Channels that do not split over the model axis raise, and so does a
    grid larger than the devices.  The int8 mode under tensor parallelism
    and streaming over a model axis raised until they were ported; they now
    run (the tests below hold their output): the int8 mode takes the
    sharded int8 layers, one max-reduce and one sum-reduce a layer."""
    params, mel, _ = jax_reference
    model = _port(params, monkeypatch, tp=True)
    with pytest.raises(ValueError, match="do not split"):
        tensor.shard_model(model, ["cpu"] * 3)
    tensor.shard_model(model, ["cpu"] * 2)
    monkeypatch.setenv("MBEXWN_WN_QUANT", "int8")
    before = dict(tensor.counts)
    with torch.no_grad():
        y = model.infer(torch.from_numpy(mel), synth_length=SYNTH)
    assert all(wn.route() == "int8" for wn in _stacks(model))
    assert y.shape == (2, SYNTH) and bool(y.isfinite().all())
    assert {k: tensor.counts[k] - before[k] for k in before} == {"reduce_add": 4, "max_reduce": 4}
    ss = StreamingSynthesizer(model, mesh=make_mesh(n_model=2, devices=["cpu", "cpu"]))
    assert all(wn.tp_devices == (torch.device("cpu"),) * 2 for wn in _stacks(ss.model))
    with pytest.raises(ValueError, match="n_data=3 x n_model=2"):
        make_mesh(n_data=3, n_model=2, devices=["cpu"] * 4)


@pytest.mark.parametrize("groups", [1, 2])
def test_int8_layers_under_tensor_parallelism(groups, monkeypatch):
    """Each int8 layer split over 2 model devices against the unsharded int8
    layer on the same inputs: every weight is quantized whole and the
    res/skip input's scale comes from the max-reduce, so each shard
    quantizes as the whole layer does and only the fp32 sum order of the
    partials differs (1e-5; a rounding-bin flip would show as ~1e-3 and
    fail)."""
    net = _trainable_stack(torch.float32, n_ch_groups=groups)
    for m in net.modules():
        if isinstance(m, Conv1DWeightNorm):
            m.fold_()
    net.differentiable = False
    tensor.shard_model(net, ["cpu"] * 2)
    monkeypatch.setenv("MBEXWN_WN_QUANT", "int8")
    rng = np.random.RandomState(3)
    Cg = net.n_grp_channels
    with torch.no_grad():
        whole, shards = net.int8_weights(torch.float32), net._tp_int8_weights(torch.float32)
        for li, dilation in enumerate(np.repeat(net.dilations, groups)):
            x = torch.from_numpy(rng.randn(2, 40, Cg).astype(np.float32))
            cond = torch.from_numpy(rng.randn(2, 40, 2 * Cg).astype(np.float32) * 0.5)
            ref = int8_layer(x, cond, whole[li], int(dilation), net.activation)
            got = tensor.sharded_int8_layer(x, tensor.scatter_rows(cond, net.tp_devices), shards[li],
                                            net.tp_devices, net.activation, int(dilation))
            assert rel_rms(got.numpy(), ref.numpy()) <= 1e-5, (li, rel_rms(got.numpy(), ref.numpy()))


def test_int8_synthesis_under_tensor_parallelism(jax_reference, monkeypatch):
    """The whole synthesis in the int8 mode over a 1 x 2 grid: against the
    port's unsharded int8 (1e-5) and against JAX's int8 within 0.1 x JAX's
    int8-against-fp distance."""
    params, mel, j_fp = jax_reference
    monkeypatch.setenv("MBEXWN_WN_QUANT", "int8")
    hp = _edit(jax_read_config(mv.get_config_file("SPEECH")))
    jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
    j_q = np.asarray(jmodel.infer(params, jnp.asarray(mel), synth_length=SYNTH))
    plain = _port(params, monkeypatch, tp=False)
    model = _port(params, monkeypatch, tp=True)
    replica = replicate(model, make_mesh(n_model=2, devices=["cpu", "cpu"]))[torch.device("cpu")]
    before = quant.int_mm_calls
    with torch.no_grad():
        y_plain = plain.infer(torch.from_numpy(mel), synth_length=SYNTH).numpy()
        calls = quant.int_mm_calls - before
        y_tp = replica.infer(torch.from_numpy(mel), synth_length=SYNTH).numpy()
    assert calls == 2 * 2 * 2 and quant.int_mm_calls - before == calls + 2 * calls  # 2 products a shard a layer
    assert rel_rms(y_tp, y_plain) <= 1e-5, rel_rms(y_tp, y_plain)
    assert rel_rms(y_tp, j_q) < 0.1 * rel_rms(j_q, j_fp), (rel_rms(y_tp, j_q), rel_rms(j_q, j_fp))


@pytest.mark.parametrize("n_data,n_model", [(2, 2), (1, 2)])
def test_streaming_over_a_model_axis(jax_reference, monkeypatch, n_data, n_model):
    """`synth_batched` over a grid, channels split over "model" and the
    uniform chunk group over "data", against the port at mesh=None (1e-5)
    and JAX's `synth_batched` at mesh=None on the same chunk geometry
    (1e-4)."""
    params, _, _ = jax_reference
    mell = (np.random.RandomState(5).randn(1, 48, 80) * 0.5 - 4).astype(np.float32)
    hp = _edit(jax_read_config(mv.get_config_file("SPEECH")))
    jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
    ref_jax = JaxStreamingSynthesizer(jmodel, params, chunk_frames=8, halo_frames=4).synth_batched(mell)
    model = _port(params, monkeypatch, tp=True)
    ref = StreamingSynthesizer(model, chunk_frames=8, halo_frames=4, device="cpu").synth_batched(mell)
    mesh = make_mesh(n_data=n_data, n_model=n_model, devices=["cpu"] * (n_data * n_model))
    ss = StreamingSynthesizer(model, chunk_frames=8, halo_frames=4, mesh=mesh)
    assert all(wn.tp_devices == (torch.device("cpu"),) * n_model for wn in _stacks(ss.model))
    reduces = tensor.counts["reduce_add"]
    got = ss.synth_batched(mell)
    assert tensor.counts["reduce_add"] > reduces
    assert got.shape == ref.shape == ref_jax.shape == (1, 48 * 300)
    assert rel_rms(got, ref) <= 1e-5, rel_rms(got, ref)
    assert rel_rms(got, ref_jax) <= 1e-4, rel_rms(got, ref_jax)
