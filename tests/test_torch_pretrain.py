"""The port's activation pretraining (`training.pretrain`) against the JAX
package's, on the CPU, with the tiny case of `training.parity` and the JAX
package's init carried across by `params_from_jax`.

The mask selects the same JAX leaves (g, b, alpha).  The stats loss and
its per-layer terms, and three `pretrain_activations` iterations, are held
in fp64 against the JAX package run in fp64 (`jax_in_fp64`) at 1e-7, given
the JAX package's own noise draws (its keys, split in its order).  Frozen
leaves stay bit-equal, and the model's route is set back afterwards.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mbexwn_vocoder_tpu.training.pretrain as jax_pretrain
from mbexwn_vocoder_tpu.models import create_model as jax_create_model

from mbexwn_vocoder_torch.compat.params_io import flatten, jax_path, params_from_jax
from mbexwn_vocoder_torch.models import create_model
from mbexwn_vocoder_torch.training.parity import TINY_BATCH as B, TINY_T_MEL as T_MEL, hold_leaves, tiny_hparams
from mbexwn_vocoder_torch.training.pretrain import activation_stats_loss, pretrain_activations, pretrainable_mask

from tests.test_torch_training import jax_in_fp64

torch.set_num_threads(2)
ITERS, LR = 3, 5e-2


@pytest.fixture(scope="module")
def case():
    hp = tiny_hparams()
    jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
    params = jax.jit(lambda k: jmodel.init(k, batch_size=B, T_mel=T_MEL))(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    mels = [(rng.randn(B, T_MEL, 80) * 0.5 - 4).astype(np.float32) for _ in range(2)]
    return hp, jax.device_get(params), mels


def port_model(hp, params, dtype=torch.float64):
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"], trainable=True)
    model.block.load_state_dict(params_from_jax(flatten(params)), strict=True)
    return model.to(dtype)


def _noise_shape(model):
    return (B, model.block.wn_input_length(T_MEL), 1)


def _to64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)


def test_mask_selects_the_jax_leaves(case):
    hp, params, _ = case
    jax_mask = flatten(jax_pretrain.pretrainable_mask(params))
    model = port_model(hp, params)
    mask = pretrainable_mask(model)
    chosen = {jax_path(name) for name, on in mask.items() if on}
    assert chosen == {path for path, on in jax_mask.items() if on}
    assert len(chosen) > 10 and not any(p.endswith("/v") for p in chosen) and "wavetables" not in chosen
    assert any(name.endswith(".bias") for name, on in mask.items() if on)  # the JAX leaf "b"


def test_stats_loss_and_layers_match_jax_fp64(case, monkeypatch):
    hp, params, mels = case
    with jax_in_fp64(monkeypatch):
        jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
        j_loss, j_layers = jax.jit(lambda p, m: jax_pretrain.activation_stats_loss(jmodel, p, m, target=1.0))(
            _to64(params), jnp.asarray(mels[0], jnp.float64))
        j_layers = {k: float(v) for k, v in j_layers.items()}
        j_loss = float(j_loss)
    model = port_model(hp, params)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(0), _noise_shape(model), jnp.float32))  # JAX's default
    model.set_differentiable(True)
    loss, layers = activation_stats_loss(model, torch.from_numpy(mels[0]).double(), 1.0,
                                         noise=torch.from_numpy(noise).double())
    loss, layers = float(loss.detach()), {k: float(v.detach()) for k, v in layers.items()}
    print(f"stats loss {loss:.15g} vs JAX {j_loss:.15g}, {len(layers)} named layers")
    assert layers.keys() == j_layers.keys() and len(layers) > 10
    assert abs(loss / j_loss - 1) <= 1e-7
    worst = max((abs(layers[k] / j_layers[k] - 1), k) for k in j_layers)
    assert worst[0] <= 1e-7, worst


def test_pretrain_iterations_match_jax_fp64(case, monkeypatch):
    hp, params, mels = case
    with jax_in_fp64(monkeypatch):
        jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
        j_new, j_loss = jax_pretrain.pretrain_activations(jmodel, _to64(params), [jnp.asarray(m, jnp.float64)
                                                                                  for m in mels],
                                                          target=1.0, max_iters=ITERS, lr=LR, to_rmse=1e-6)
        j_new = params_from_jax({k: np.asarray(v) for k, v in flatten(j_new).items()})
    model = port_model(hp, params)
    # the JAX package's draws: its key PRNGKey(0), split once an iteration
    key, noises = jax.random.PRNGKey(0), []
    for _ in range(ITERS):
        key, sub = jax.random.split(key)
        noises.append(np.array(jax.random.normal(sub, _noise_shape(model), jnp.float32)))
    start = {k: v.clone() for k, v in model.block.state_dict().items()}
    routes = {m.differentiable for m in model.modules() if hasattr(m, "differentiable")}
    loss = pretrain_activations(model, mels, target=1.0, max_iters=ITERS, lr=LR, to_rmse=1e-6, noises=noises)
    assert {m.differentiable for m in model.modules() if hasattr(m, "differentiable")} == routes == {False}
    assert all(p.requires_grad and p.grad is None for p in model.parameters())
    got = model.block.state_dict()
    mask = pretrainable_mask(model)
    frozen = [k for k in got if not mask.get(k, False)]
    assert frozen and all(torch.equal(got[k], start[k]) for k in frozen)
    moved = {k: got[k] - start[k] for k in got if mask.get(k, False)}
    ref = {k: j_new[k].double() - start[k] for k in moved}
    bad, rows = hold_leaves(moved, ref, 1e-7)
    print(f"pretraining, {ITERS} iterations: loss {loss:.15g} vs JAX {j_loss:.15g}; worst leaf update "
          f"{rows[0][1]} {rows[0][0]:.2e} of {len(rows)}")
    assert abs(loss / j_loss - 1) <= 1e-7
    assert not bad, bad
    assert max(float(v.abs().max()) for v in moved.values()) > 0


def test_pretraining_lowers_the_stats_loss_in_fp32(case):
    """The calibration does what it is for: the fp32 stats loss falls."""
    hp, params, mels = case
    model = port_model(hp, params, torch.float32)
    gen = torch.Generator().manual_seed(0)
    model.set_differentiable(True)
    with torch.no_grad():
        before = float(activation_stats_loss(model, torch.from_numpy(mels[0]), 1.0, generator=gen)[0])
    model.set_differentiable(False)
    after = pretrain_activations(model, mels, target=1.0, max_iters=20, lr=LR)
    assert np.isfinite(before) and after < before
