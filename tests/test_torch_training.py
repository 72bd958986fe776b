"""The port's training slice against the JAX package's, on the CPU.

The tiny case of `mbexwn_vocoder_torch.training.parity` (SPEECH with a
16-channel, 2-layer WaveNet, F0 loss, teacher forcing 0.5, coherence 0.1),
T_mel = 8, batch 2.  Parameters come from the JAX package's `init` and are
carried across by `params_from_jax`; the step's random draws are the JAX
trainer's own (the same key, split in its order) handed to the port.

Loss and gradients, every leaf and the wavetables included, are held
against `jax.value_and_grad(Trainer.loss_fn)` twice:

- in fp64 on both sides, every leaf within 1e-7 rel-RMS and the loss within
  1e-12.  The JAX package runs under `jax.enable_x64` with its hard-coded
  float32 read as float64 (`jax_fp64`), its STFT through the FFT (its
  default twiddle matmul holds fp32-rounded twiddles) and its draws taken in
  float32, as the fp32 step takes them;
- in fp32, the loss and its terms within 1e-5 of the JAX package's fp32
  step, and each gradient leaf within 1e-4 rel-RMS of the exact (JAX fp64)
  gradient, or within the bound that `FP32_GRADIENT_BOUNDS` names for it.
  The test prints the JAX package's own fp32 distance from the exact
  gradient beside each.

A leaf whose norm is under 1e-6 of the largest is held to 1e-7 absolute.
"""
import contextlib
import copy
import fnmatch
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mbexwn_vocoder_tpu.compat.params_io import load_params as jax_load_params
from mbexwn_vocoder_tpu.models import create_model as jax_create_model
from mbexwn_vocoder_tpu.ops import stft_ops as jax_stft_ops
from mbexwn_vocoder_tpu.ops.conv import fold_weight_norm as jax_fold
from mbexwn_vocoder_tpu.training import Trainer as JaxTrainer
from mbexwn_vocoder_tpu.training.schedules import ParamSchedule as JaxParamSchedule
from mbexwn_vocoder_tpu.training.trainer import _make_optimizer as jax_make_optimizer
from mbexwn_vocoder_tpu.training.trainer import fast_forward_opt_state as jax_fast_forward

from mbexwn_vocoder_torch import get_config_file
from mbexwn_vocoder_torch.compat.params_io import flatten, load_params, params_from_jax, params_to_jax, save_params
from mbexwn_vocoder_torch.config import read_config
from mbexwn_vocoder_torch.mel_inverter import MELInverter
from mbexwn_vocoder_torch.models import create_model
from mbexwn_vocoder_torch.nn.layers import Conv1DWeightNorm
from mbexwn_vocoder_torch.nn.wavenet import WaveNetAE
from mbexwn_vocoder_torch.training.parity import (TINY_BATCH as B, TINY_T_MEL as T_MEL, hold_leaves, rel_rms,
                                                   tiny_batch, tiny_hparams)
from mbexwn_vocoder_torch.training.schedules import ParamSchedule
from mbexwn_vocoder_torch.training.trainer import (Trainer, clip_by_global_norm_, fast_forward_opt_state,
                                                    make_optimizer)

torch.set_num_threads(2)


def jax_draws(jtr, key, shapes):
    """The draws the JAX trainer's loss_fn takes from `key`, in its order:
    loss_fn splits off the dither key; training_forward splits (rng,
    noise_rng, floor_rng); the masking noises come from loss_fn's key after
    the dither split."""
    draws = {}
    if jtr.dither_level:
        key, sub = jax.random.split(key)
        draws["dither"] = jax.random.normal(sub, shapes["dither"], jnp.float32)
    _, noise_rng, floor_rng = jax.random.split(key, 3)
    draws["noise"] = jax.random.normal(noise_rng, shapes["noise"], jnp.float32)
    draws["floor"] = jax.random.uniform(floor_rng, shapes["floor"], minval=-1.0, maxval=1.0)
    for name, on in (("rel_masking_noise", jtr.spect_losses.rel_masking_noise_level),
                     ("masking_noise", jtr.spect_losses.masking_noise_level)):
        if on:
            key, sub = jax.random.split(key)
            draws[name] = jax.random.normal(sub, shapes[name])
    assert set(draws) == set(shapes)
    return {k: np.array(v) for k, v in draws.items()}


@pytest.fixture(scope="module")
def jax_params():
    """The JAX package's init of the tiny model (the tree does not depend
    on the normalisation flag)."""
    hp = tiny_hparams()
    model, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
    return jax.jit(lambda k: model.init(k, batch_size=B, T_mel=T_MEL))(jax.random.PRNGKey(0))


def port_trainer(hp, params, dtype=torch.float32):
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"], trainable=True)
    model.block.load_state_dict(params_from_jax(flatten(params)), strict=True)
    return Trainer(model.to(dtype), hp, device="cpu")


CASES = {
    "base": {},
    "rms-normalised": {"mbexwn_config.normalize_rms_from_mell": True},
    "dither, TD loss, masking noises": {"training_config.dither_level": 1e-3, "training_config.TD_loss_weight": 0.5},
}


# In fp32 the gradient of the log-spectral L1 loss on this randomly
# initialised model is only determined to ~1e-3 (training.parity), so the
# fp32 gradients of the leaves that feed the synthesised signal are held to
# the exact gradient at these bounds instead of 1e-4: leaf pattern -> bound,
# the first match wins.  Each bound is 2-4x the port's largest fp32 error on
# the leaves it names over the three cases below; the JAX package's own fp32
# errors on the same leaves are in the comments.
FP32_GRADIENT_BOUNDS = {
    "PP_waveNetBlock_*": 1e-2,  # the two WaveNet blocks: port up to 2.5e-3, JAX up to 3.8e-3
    "wn_post_net.*": 5e-3,      # port 1.5e-3, JAX 1.6e-3
    "wavetables": 5e-3,         # port 2.0e-3, JAX 1.6e-3
    "pp_subnet.*": 5e-3,        # the F0 net: port 2.2e-3, JAX up to 2.3 (its fp32 phase)
    "ps_subnet.*": 5e-4,        # the envelope net: port 1.5e-4, JAX 2.3e-4
}


def fp32_gradient_bound(name):
    return next((b for pattern, b in FP32_GRADIENT_BOUNDS.items() if fnmatch.fnmatchcase(name, pattern)), 1e-4)


class _Float64Numpy(types.ModuleType):
    """jax.numpy with `float32` read as float64, and float32 host arrays
    promoted to float64 where they become jax arrays: the JAX package's
    modules see this in place of `jnp` for the fp64 reference run."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(a, dtype=None, **kwargs):
        a = jnp.asarray(a, dtype, **kwargs)
        return a.astype(jnp.float64) if dtype is None and a.dtype == jnp.float32 else a

    array = asarray


def _float32_draw(draw):
    """A jax.random draw taken in float32 and widened: the fp64 run draws
    the values that the fp32 step draws."""
    def widened(key, shape=(), dtype=None, *args, **kwargs):
        return draw(key, shape, jnp.float32, *args, **kwargs).astype(jnp.float64)
    return widened


@contextlib.contextmanager
def jax_in_fp64(monkeypatch):
    """The JAX package's modules (those imported so far) run unchanged under
    `jax.enable_x64`, with `_Float64Numpy` for their `jnp`, the STFT through
    the FFT, and the draws in float32."""
    with monkeypatch.context() as mp:
        mp.setattr(jax_stft_ops, "STFT_METHOD", "fft")
        for name, module in list(sys.modules.items()):
            if name.startswith("mbexwn_vocoder_tpu") and getattr(module, "jnp", None) is jnp:
                mp.setattr(module, "jnp", _Float64Numpy("jnp"))
        mp.setattr(jax.random, "normal", _float32_draw(jax.random.normal))
        mp.setattr(jax.random, "uniform", _float32_draw(jax.random.uniform))
        with jax.enable_x64(True):
            yield


def jax_fp64(monkeypatch, hp, params, batch, key):
    """(loss, {leaf: gradient}) of the JAX package's `Trainer.loss_fn` in
    fp64 (`jax_in_fp64`)."""
    with jax_in_fp64(monkeypatch):
        jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
        jtr = JaxTrainer(jmodel, copy.deepcopy(hp))
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), params)
        (loss, _), grads = jax.jit(jax.value_and_grad(jtr.loss_fn, has_aux=True))(
            p64, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(0), key)
        grads = {k: np.asarray(v) for k, v in flatten(grads).items()}
        assert all(v.dtype == np.float64 for v in grads.values())
        return float(loss), params_from_jax(grads)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_jax(jax_params, case, monkeypatch):
    hp = tiny_hparams(**CASES[case])
    if case.startswith("dither"):
        slc = hp["training_config"]["spect_loss_config"]
        slc["rel_masking_noise_atten_db"] = 30.0
        slc["masking_noise_std"] = 1e-3
    monkeypatch.setenv("MBEXWN_PALLAS_WN", "0")  # the JAX Trainer sets it for the process; gone after the test
    jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
    jtr = JaxTrainer(jmodel, copy.deepcopy(hp))
    batch = tiny_batch()
    key = jax.random.PRNGKey(3)
    (j_loss, j_metrics), j_grads = jax.jit(jax.value_and_grad(jtr.loss_fn, has_aux=True))(
        jax_params, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(0), key)
    j_loss64, exact = jax_fp64(monkeypatch, hp, jax_params, batch, key)

    tr = port_trainer(hp, jax_params)
    draws = jax_draws(jtr, key, tr.draw_shapes(batch))
    loss, metrics, grads = tr.value_and_grad(batch, 0, draws)
    loss64, _, grads64 = port_trainer(hp, jax_params, torch.float64).value_and_grad(batch, 0, draws)

    # fp64: the same function and gradient
    assert abs(float(loss64) / j_loss64 - 1) <= 1e-12, (float(loss64), j_loss64)
    assert "wavetables" in exact
    bad64, rows64 = hold_leaves(grads64, exact, 1e-7)
    # fp32: the loss and its terms against the JAX fp32 step, the gradients against the exact ones
    assert abs(float(loss) / float(j_loss) - 1) <= 1e-5, (float(loss), float(j_loss))
    assert set(metrics) == set(j_metrics)
    for name in metrics:
        assert abs(float(metrics[name]) / float(j_metrics[name]) - 1) <= 1e-5, (name, metrics[name], j_metrics[name])
    bad32, rows32 = hold_leaves(grads, exact, fp32_gradient_bound)
    jax32 = params_from_jax(flatten(j_grads))
    groups = {}
    for e, n, b in rows32:
        pattern = next((p for p in FP32_GRADIENT_BOUNDS if fnmatch.fnmatchcase(n, p)), "other")
        port_e, jax_e = groups.get(pattern, (0.0, 0.0))
        groups[pattern] = (max(port_e, e), max(jax_e, rel_rms(jax32[n], exact[n])))
    print(f"[{case}] fp64: loss {float(loss64):.15g} vs JAX {j_loss64:.15g}, worst leaf {rows64[0][1]} "
          f"{rows64[0][0]:.2e}; fp32: loss {float(loss):.7g} vs JAX {float(j_loss):.7g}, "
          f"{sum(e > 1e-4 for e, _, _ in rows32)} of {len(rows32)} leaves over 1e-4; worst against the exact "
          f"gradient, port / JAX fp32, by group: "
          + ", ".join(f"{p} {pe:.2e} / {je:.2e}" for p, (pe, je) in groups.items()))
    assert not bad64, bad64
    assert not bad32, bad32


def test_oscillator_f0_gradient():
    """The F0 gradient through the oscillator (phase, lookup, cross-fade)
    against an fp64 evaluation of the port's: the port's within 1e-5 at 120
    and 320 Hz; JAX's within 1e-5 at 120 Hz, and beyond 1e-4 at 320 Hz,
    where its fp32 phase sum (~27 cycles within a 1000-sample chunk) puts
    samples on other linear segments of the table."""
    from mbexwn_vocoder_tpu.ops import oscillator as jax_osc
    from mbexwn_vocoder_torch.ops.oscillator import oscillate_plain

    hp = tiny_hparams()
    jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
    wt = jmodel.block.wavetable
    tables = np.asarray(wt.wavetables, np.float32)
    consts = (wt.nominalF0, wt.F0GridFactor, wt.min_transposition, wt.max_transposition)
    rng = np.random.RandomState(0)
    for f0, jax_ok in ((120.0, True), (320.0, False)):
        pf = (f0 + rng.randn(B, 1200) * 2).astype(np.float32)
        R = rng.randn(B, 1200)

        def port_grad(dtype):
            t = torch.from_numpy(pf).to(dtype).requires_grad_()
            audio = oscillate_plain(t, torch.from_numpy(tables).to(dtype), *consts, wt.sample_rate)
            (audio * torch.from_numpy(R).to(dtype)).sum().backward()
            return t.grad.numpy()

        def jax_loss(f):
            phase = jax_osc.stable_cumsum_and_wrap(f / wt.sample_rate)
            audio = jax_osc.grid_crossfade(jax_osc.wavetable_lookup(phase, jnp.asarray(tables)), f, *consts)
            return jnp.sum(audio * jnp.asarray(R, jnp.float32))

        exact = port_grad(torch.float64)
        port, ref = rel_rms(port_grad(torch.float32), exact), rel_rms(np.asarray(jax.grad(jax_loss)(pf)), exact)
        print(f"F0 {f0} Hz: F0 gradient vs fp64, port {port:.2e}, JAX {ref:.2e}")
        assert port <= 1e-5 and (ref <= 1e-5 if jax_ok else ref > 1e-4)


def test_inference_route_refuses_grad_and_training_route_differentiates():
    """Grad mode through the WaveNet's inference route raises; it never
    gives a silent no-gradient.  The differentiable route gives every
    layer's v, g and bias a non-zero gradient."""
    torch.manual_seed(0)
    net = WaveNetAE(7, 10, n_channels=16, n_layers=3, kernel_size=3, n_out_channels=8, max_log2_dilation_rate=7,
                    cond_kernel_size=3, cond_conv_upsampling=2, cond_lin_upsampling=4)
    x, mel = torch.randn(2, 64, 7), torch.randn(2, 8, 10)
    with pytest.raises(RuntimeError, match="no backward pass"):
        net(x, mel)
    with torch.no_grad():
        folded = net(x, mel)
    gen = torch.Generator().manual_seed(1)
    for m in net.modules():
        if isinstance(m, Conv1DWeightNorm):
            m.trainable_()
            m.init(gen)
    with pytest.raises(RuntimeError, match="no backward pass"):
        net(x, mel)
    net.differentiable = True
    net(x, mel).square().sum().backward()
    for i in range(3):
        for layer in (f"conv1D_{i}", f"res_skip_{i}"):
            for p in ("v", "g", "bias"):
                grad = getattr(getattr(net, layer), p).grad
                assert grad is not None and float(grad.abs().max()) > 0, (layer, p)
    assert folded.shape == x.shape[:2] + (8,)


def test_fold_returns_a_trained_model_to_the_kernels_route(jax_params, monkeypatch):
    """The trainer puts the model on the differentiable route; `fold_()`
    puts it back on the kernels' route: its synthesis calls the kernels'
    entries (`wavenet_stack` once a block, `oscillate` once), as a model that
    was never trained does."""
    import mbexwn_vocoder_torch.models.mbexwn as port_mbexwn
    import mbexwn_vocoder_torch.nn.wavenet as port_wavenet

    hp = tiny_hparams()
    tr = port_trainer(hp, jax_params)
    routes = lambda: {m.differentiable for m in tr.model.modules() if hasattr(m, "differentiable")}
    assert routes() == {True}
    tr.train_step(tiny_batch())
    tr.model.fold_()
    assert routes() == {False} and not tr.model.trainable
    calls = []
    for module, name in ((port_wavenet, "wavenet_stack"), (port_mbexwn, "oscillate")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _real=real, _name=name, **k: calls.append(_name) or _real(*a, **k))
    with torch.inference_mode():
        y = tr.model.infer(torch.from_numpy(tiny_batch(seed=2)["mel"]), T_MEL * 300)
    assert sorted(calls) == ["oscillate"] + ["wavenet_stack"] * len(tr.model.block.block_names), calls
    assert torch.isfinite(y).all()


@pytest.mark.parametrize("activation", ["gtu", "glu", "gfu", "gsu"])
def test_differentiable_route_equals_the_stack(activation):
    """The per-layer route and the stack route (its plain version on the
    CPU) compute one function, for every gate."""
    torch.manual_seed(2)
    net = WaveNetAE(7, 10, n_channels=16, n_layers=4, kernel_size=3, n_out_channels=8, max_log2_dilation_rate=7,
                    cond_kernel_size=3, cond_conv_upsampling=2, cond_lin_upsampling=4, activation=activation)
    x, mel = torch.randn(2, 64, 7), torch.randn(2, 8, 10)
    with torch.no_grad():
        y_stack = net(x, mel)
        net.differentiable = True
        y_layers = net(x, mel)
    torch.testing.assert_close(y_layers, y_stack, rtol=1e-5, atol=1e-6)


def test_bf16_grads_track_fp32(jax_params, monkeypatch):
    """The shipped bf16 compute modes: gradients finite and with cosine > 0.98
    against the fp32 ones (the JAX package's test_bf16_train_step_grads)."""
    hp = tiny_hparams()
    batch = tiny_batch()
    grads = {}
    for dtype in ("bfloat16", ""):
        monkeypatch.setenv("MBEXWN_WN_DTYPE", dtype)
        monkeypatch.setenv("MBEXWN_SUBNET_DTYPE", dtype)
        tr = port_trainer(hp, jax_params)
        assert (tr.model.block.wn_compute_dtype is not None) == bool(dtype)
        draws = {k: torch.randn(s, generator=torch.Generator().manual_seed(4)) for k, s in tr.draw_shapes(batch).items()}
        loss, _, g = tr.value_and_grad(batch, 0, draws)
        assert np.isfinite(float(loss))
        grads[dtype] = torch.cat([v.flatten().double() for _, v in sorted(g.items())])
    assert torch.isfinite(grads["bfloat16"]).all()
    cos = float(torch.dot(grads["bfloat16"], grads[""]) / (grads["bfloat16"].norm() * grads[""].norm()))
    print(f"bf16 / fp32 gradient cosine {cos:.5f}")
    assert cos > 0.98, cos


def test_train_step_lowers_the_loss_and_draws_follow_the_seed(jax_params):
    hp = tiny_hparams()
    batch = tiny_batch()
    losses = []
    for _ in range(2):
        tr = port_trainer(hp, jax_params)
        losses.append([float(tr.train_step(batch)["total_loss"]) for _ in range(3)])
    assert losses[0] == losses[1]  # the trainer's generator, seeded 0
    assert losses[0][-1] < losses[0][0]
    assert tr.step == 3


def test_trainer_refuses_what_it_does_not_take(jax_params):
    hp = tiny_hparams()
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"])
    with pytest.raises(ValueError, match="folded"):
        Trainer(model, hp, device="cpu")
    # remat_wavenet_blocks is taken: the trainer builds and the blocks recompute in the backward pass
    hp_remat = tiny_hparams(**{"mbexwn_config.remat_wavenet_blocks": True})
    tr_remat = port_trainer(hp_remat, jax_params)
    assert tr_remat.model.block.remat_wavenet_blocks and tr_remat.model.block.differentiable
    tr = port_trainer(hp, jax_params)
    batch = tiny_batch()
    draws = {k: np.zeros(s, np.float32) for k, s in tr.draw_shapes(batch).items()}
    draws["noise"] = draws["noise"][:, :-1]
    with pytest.raises(ValueError, match="noise"):
        tr.loss_fn(batch, 0, draws)
    with pytest.raises(KeyError):
        tr.loss_fn(batch, 0, {})


def test_remat_gradients_equal_non_remat_and_jax(jax_params, monkeypatch):
    """remat_wavenet_blocks: each WaveNet block goes through
    torch.utils.checkpoint on the training route.  In fp64 the loss and every
    gradient leaf equal the non-remat step's within 1e-12 and the JAX
    package's remat step (jax.checkpoint around each block) within 1e-7, the
    draws injected so the recomputation sees the same noise; the blocks'
    forward runs twice a step."""
    import mbexwn_vocoder_torch.nn.wavenet as port_wavenet

    hp = tiny_hparams()
    hp_remat = tiny_hparams(**{"mbexwn_config.remat_wavenet_blocks": True})
    batch = tiny_batch()
    key = jax.random.PRNGKey(5)
    monkeypatch.setenv("MBEXWN_PALLAS_WN", "0")
    jtr = JaxTrainer(jax_create_model(hp_remat, hp_remat["training_config"], hp_remat["preprocess_config"],
                                      quiet=True)[0], copy.deepcopy(hp_remat))
    assert jtr.model.block.remat_wavenet_blocks
    j_loss64, j_grads64 = jax_fp64(monkeypatch, hp_remat, jax_params, batch, key)
    tr = port_trainer(hp, jax_params, torch.float64)
    draws = jax_draws(jtr, key, tr.draw_shapes(batch))
    loss, _, grads = tr.value_and_grad(batch, 0, draws)
    grads = {k: v.clone() for k, v in grads.items()}
    calls = []
    real = port_wavenet.WaveNetAE.forward
    monkeypatch.setattr(port_wavenet.WaveNetAE, "forward", lambda self, *a: calls.append(1) or real(self, *a))
    loss_r, _, grads_r = port_trainer(hp_remat, jax_params, torch.float64).value_and_grad(batch, 0, draws)
    n_blocks = len(tr.model.block.block_names)
    assert len(calls) == 2 * n_blocks, calls  # forward, then once more in the backward pass
    assert abs(float(loss_r) / float(loss) - 1) <= 1e-12
    assert abs(float(loss_r) / j_loss64 - 1) <= 1e-12, (float(loss_r), j_loss64)
    bad, rows = hold_leaves(grads_r, grads, 1e-12)
    bad_jax, rows_jax = hold_leaves(grads_r, j_grads64, 1e-7)
    print(f"remat vs non-remat: worst {rows[0][1]} {rows[0][0]:.2e}; vs JAX remat: worst {rows_jax[0][1]} "
          f"{rows_jax[0][0]:.2e}")
    assert not bad, bad
    assert not bad_jax, bad_jax


# ---- the optimizer against optax, on the same gradients

SCHEDULES = {"none": None,
             "warm-up + cosine": {"type": "cosine", "warmup_steps": 2, "decay_steps": 5, "final_scale": 0.1},
             "warm-up + exponential": {"type": "exponential", "warmup_steps": 2, "decay_steps": 3,
                                       "final_scale": 0.5},
             "warm-up + constant": {"type": "constant", "warmup_steps": 2}}


def _opt_config(opt_type, schedule, clip):
    return {"optimizer": {"type": opt_type, "learning_rate": 1e-2, "beta1": 0.8, "beta2": 0.99,
                          "weight_decay": 0.1, "momentum": 0.7},
            "lr_schedule": SCHEDULES[schedule], "grad_clip_norm": 0.5 if clip else None}


def _opt_case(seed=0):
    rng = np.random.RandomState(seed)
    params = {"a": rng.randn(4, 3).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * s).astype(np.float32) for k, v in params.items()} for s in (0.3, 2.0, 0.05, 1.0)]
    return params, grads


def _apply_port(tc, params, grads, fast_forward=None):
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt, sched = make_optimizer(list(tp.values()), tc)
    if fast_forward is not None:
        fast_forward_opt_state(type("T", (), {"optimizer": opt, "scheduler": sched})(), fast_forward)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        if tc["grad_clip_norm"]:
            clip_by_global_norm_(list(tp.values()), tc["grad_clip_norm"])
        opt.step()
        sched.step()
    return {k: p.detach().numpy() for k, p in tp.items()}


def _apply_optax(tc, params, grads, fast_forward=None):
    tx = jax_make_optimizer(tc)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    if fast_forward is not None:
        state = jax_fast_forward(state, fast_forward)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
    return {k: np.asarray(v) for k, v in jp.items()}


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("opt_type", ["adam", "adamw", "sgd"])
def test_optimizer_matches_optax(opt_type, schedule, clip):
    """Three updates from the same gradients (one above the clip norm): the
    parameters within 1e-6 of optax's.  The first update runs at the
    schedule's step 0 (lr 0 in the warm-up)."""
    tc = _opt_config(opt_type, schedule, clip)
    params, grads = _opt_case()
    got, ref = _apply_port(tc, params, grads[:3]), _apply_optax(tc, params, grads[:3])
    for k in params:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6)
        assert not np.allclose(got[k], params[k])


@pytest.mark.parametrize("opt_type", ["adam", "adamw", "sgd"])
def test_fast_forward_opt_state_matches_optax(opt_type):
    """Fast-forwarded to step 4 (inside the cosine after a warm-up of 2),
    then two updates: the same parameters as optax fast-forwarded alike, and
    not those of an optimizer that starts at step 0."""
    tc = _opt_config(opt_type, "warm-up + cosine", clip=False)
    params, grads = _opt_case(1)
    got = _apply_port(tc, params, grads[:2], fast_forward=4)
    ref = _apply_optax(tc, params, grads[:2], fast_forward=4)
    fresh = _apply_port(tc, params, grads[:2])
    for k in params:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6)
        assert not np.allclose(got[k], fresh[k], rtol=0, atol=1e-5)


def test_param_schedule_matches_jax():
    cfgs = [{"initial": 0.5}, {"initial": 1.0, "final": 0.0, "type": "linear", "start_step": 10, "end_step": 50},
            {"initial": 1.0, "final": 0.01, "type": "exponential", "start_step": 0, "end_step": 40},
            {"initial": 2.0, "final": 3.0, "type": "linear", "start_step": 5, "end_step": 5}]
    for cfg in cfgs:
        port, ref = ParamSchedule(name="s", **cfg), JaxParamSchedule(name="s", **cfg)
        for step in (0, 3, 10, 11, 27, 40, 50, 75):
            assert isinstance(port(step), float)
            np.testing.assert_allclose(port(step), float(ref(step)), rtol=1e-6, atol=1e-7)


# ---- weights both ways, and the init

@pytest.mark.parametrize("model_id", ["SPEECH", "SING", "VOICE"])
def test_weights_round_trip_bit_exact(model_id):
    """The shipped (v, g) checkpoint through params_from_jax and back."""
    path = os.path.join(os.path.dirname(get_config_file(model_id)), "weights.npz")
    flat = flatten(load_params(path))
    back = params_to_jax(params_from_jax(flat))
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape and np.array_equal(back[k], v), k
    hp = read_config(get_config_file(model_id))
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"], trainable=True)
    model.block.load_state_dict(params_from_jax(flat), strict=True)


def test_trained_weights_load_in_both_packages(jax_params, tmp_path):
    """A port-trained tiny model (one step), written with save_params in
    the trainable form, loads in the JAX package (load_params,
    fold_weight_norm, PaNWaveNet.infer) and in the port's MELInverter on the
    CPU; the two synthesise the same audio within 1e-3 rel-RMS (the full
    synthesis budget), given the JAX package's noise draw."""
    import yaml

    hp = tiny_hparams()
    tr = port_trainer(hp, jax_params)
    tr.train_step(tiny_batch())
    assert tr.model.trainable
    save_params(str(tmp_path / "weights.npz"), params_to_jax(tr.model.block.state_dict()))
    with open(tmp_path / "config.yaml", "w") as f:
        # numpy scalars as floats, numpy types (training_config.ftype) as the config spells them
        yaml.safe_dump(json.loads(json.dumps(hp, default=lambda o: f"np.{o.__name__}" if isinstance(o, type)
                                             else float(o))), f)

    jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
    jparams = jax_fold(jax_load_params(str(tmp_path / "weights.npz")))
    mel = tiny_batch(seed=2)["mel"][:1]
    y_jax = np.asarray(jmodel.infer(jparams, jnp.asarray(mel), synth_length=T_MEL * 300))

    inv = MELInverter(str(tmp_path), device="cpu", length_buckets=(T_MEL,))
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(0), inv.noise_shape(mel), jnp.float32))
    y_port = inv.synth_from_mel(mel, noise=noise)
    assert y_port.shape == (T_MEL * 300,) and np.isfinite(y_port).all()
    assert rel_rms(y_port, y_jax[0]) <= 1e-3, rel_rms(y_port, y_jax[0])
    # the trained weights, not the initial ones
    assert not np.array_equal(flatten(jax_load_params(str(tmp_path / "weights.npz")))["wn_post_net/v"],
                              np.asarray(jax_params["wn_post_net"]["v"]))


def _init_scales(flat):
    """{conv path: mean of g over its output channels} (g = ||v|| at init)."""
    return {k[:-2]: float(np.mean(v)) for k, v in flat.items() if k.endswith("/g")}


def test_init_matches_jax_tree_and_scales(jax_params):
    """The port's init has the JAX init's tree (keys, shapes); g = ||v|| per
    channel, bias 0, PReLU alpha and the wavetables exactly; and the scale
    of every conv (mean g over channels, averaged over 8 inits on each
    side, so that a single draw's spread does not decide) within 10%."""
    hp = tiny_hparams()
    jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
    jinit = jax.jit(lambda k: jmodel.init(k, batch_size=B, T_mel=T_MEL))
    jax_flats = [flatten(jax.device_get(jinit(jax.random.PRNGKey(s)))) for s in range(8)]
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"], trainable=True)
    port_flats = []
    for s in range(8):
        model.init(torch.Generator().manual_seed(s), batch_size=B, T_mel=T_MEL)
        port_flats.append(params_to_jax(model.block.state_dict()))
    ref, got = jax_flats[0], port_flats[0]
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        if k.endswith("/b"):
            assert not got[k].any()
        if k.endswith("/alpha") or k == "wavetables":
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
        if k.endswith("/v"):
            norm = np.sqrt(np.sum(got[k].astype(np.float64) ** 2, axis=(0, 1)))
            np.testing.assert_allclose(got[k[:-2] + "/g"], norm, rtol=1e-5, err_msg=k)
    port_scale = {k: np.mean([_init_scales(f)[k] for f in port_flats]) for k in _init_scales(got)}
    jax_scale = {k: np.mean([_init_scales(f)[k] for f in jax_flats]) for k in _init_scales(ref)}
    worst = max((abs(port_scale[k] / jax_scale[k] - 1), k) for k in jax_scale)
    print(f"init scale, worst conv {worst[1]}: {worst[0]:.3f}")
    assert worst[0] <= 0.1, worst
