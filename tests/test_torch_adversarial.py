"""The port's adversarial training (`training.discriminator`,
`training.adversarial`) against the JAX package's, on the CPU.

The discriminator, carried across from the JAX package's init by
`params_from_jax`, gives the JAX package's logits and feature maps (fp32,
1e-5 rel-RMS), stride-4 SAME padding included; the GAN losses match.  Two
GAN steps of the tiny case of `training.parity` with a small discriminator,
given the JAX package's draws (its keys, split in its order), move every
generator and discriminator leaf as the JAX package's steps do, in fp64
(`jax_in_fp64`) within 1e-7.  The port runs one generator forward per
generator loss, and `disable_discriminator` gives the plain trainer's step.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mbexwn_vocoder_tpu.training.adversarial as jax_adv
import mbexwn_vocoder_tpu.training.discriminator as jax_disc
from mbexwn_vocoder_tpu.models import create_model as jax_create_model
from mbexwn_vocoder_tpu.ops.conv import same_pads as jax_same_pads
from mbexwn_vocoder_tpu.training.trainer import TrainState as JaxTrainState

from mbexwn_vocoder_torch.compat.params_io import flatten, params_from_jax, params_to_jax
from mbexwn_vocoder_torch.models import create_model
from mbexwn_vocoder_torch.ops.conv import same_pads
from mbexwn_vocoder_torch.training import discriminator as port_disc
from mbexwn_vocoder_torch.training.adversarial import AdversarialTrainer
from mbexwn_vocoder_torch.training.parity import (TINY_BATCH as B, TINY_T_MEL as T_MEL, TINY_WAVEGAN as WAVEGAN,
                                                   gan_card_against_cpu, hold_leaves, rel_rms, tiny_batch,
                                                   tiny_hparams)
from mbexwn_vocoder_torch.training.trainer import Trainer

from tests.test_torch_training import jax_draws, jax_in_fp64

torch.set_num_threads(2)
DISC = WAVEGAN["discriminator_config"]
GAN_STEPS = 2


def _gan_hparams(**wavegan):
    hp = tiny_hparams()
    hp["wavegan_config"] = copy.deepcopy(dict(WAVEGAN, **wavegan))
    return hp


def _port_disc(params, dtype=torch.float32, **cfg):
    d = port_disc.MultiScaleDiscriminator(**cfg)
    d.load_state_dict(params_from_jax(flatten(params)), strict=True)
    return d.to(dtype)


@pytest.fixture(scope="module")
def jax_init():
    """The JAX package's init of the tiny generator and of the small discriminator."""
    hp = _gan_hparams()
    jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
    gen = jax.jit(lambda k: jmodel.init(k, batch_size=B, T_mel=T_MEL))(jax.random.PRNGKey(0))
    cfg = {k: v for k, v in DISC.items() if k != "loss_method"}
    disc, _ = jax_disc.MultiScaleDiscriminator(**cfg).init(jax.random.PRNGKey(1), (B, T_MEL * 300, 1))
    return jax.device_get(gen), jax.device_get(disc)


@pytest.mark.parametrize("in_len", [2400, 2405, 601, 150, 37, 4])
@pytest.mark.parametrize("kernel,stride", [(15, 4), (15, 1), (5, 1), (3, 1), (4, 2)])
def test_strided_same_pads_match_jax(in_len, kernel, stride):
    assert same_pads(kernel, 1, stride, in_len) == jax_same_pads(kernel, 1, stride, in_len)


@pytest.mark.parametrize("T", [2400, 2405])
def test_discriminator_matches_jax(jax_init, T):
    """Every scale's logits and feature maps within 1e-5 rel-RMS in fp32; T =
    2405 puts each stride-4 layer on an input length no multiple of 4."""
    _, params = jax_init
    cfg = {k: v for k, v in DISC.items() if k != "loss_method"}
    audio = (np.random.RandomState(T).randn(B, T) * 0.1).astype(np.float32)
    ref = jax_disc.MultiScaleDiscriminator(**cfg)(params, jnp.asarray(audio))
    d = _port_disc(params, **cfg)
    assert params_to_jax(d.state_dict()).keys() == flatten(params).keys()
    with torch.no_grad():
        got = d(torch.from_numpy(audio))
    assert len(got) == len(ref) == DISC["n_scales"]
    for (g_logits, g_feats), (r_logits, r_feats) in zip(got, ref):
        assert len(g_feats) == len(r_feats) == DISC["n_layers"] + 1
        for g, r in zip([g_logits] + g_feats, [r_logits] + list(r_feats)):
            assert tuple(g.shape) == tuple(r.shape) and rel_rms(g, np.asarray(r)) <= 1e-5


def test_discriminator_init_matches_jax_tree(jax_init):
    _, params = jax_init
    cfg = {k: v for k, v in DISC.items() if k != "loss_method"}
    d = port_disc.MultiScaleDiscriminator(**cfg).init(torch.Generator().manual_seed(0))
    got, ref = params_to_jax(d.state_dict()), flatten(params)
    assert got.keys() == ref.keys() and all(got[k].shape == ref[k].shape for k in ref)
    for k in ref:
        if k.endswith("/g"):
            np.testing.assert_allclose(got[k], np.sqrt((got[k[:-1] + "v"].astype(np.float64) ** 2).sum(axis=(0, 1))),
                                       rtol=1e-5)
        if k.endswith("/b"):
            assert not got[k].any()


@pytest.mark.parametrize("method", ["lsgan", "hinge"])
def test_gan_losses_match_jax(jax_init, method):
    _, params = jax_init
    cfg = {k: v for k, v in DISC.items() if k != "loss_method"}
    rng = np.random.RandomState(5)
    real, fake = ((rng.randn(B, 2400) * s).astype(np.float32) for s in (0.1, 0.3))
    jd = jax_disc.MultiScaleDiscriminator(**cfg)
    j_real, j_fake = jd(params, jnp.asarray(real)), jd(params, jnp.asarray(fake))
    d = _port_disc(params, **cfg)
    with torch.no_grad():
        p_real, p_fake = d(torch.from_numpy(real)), d(torch.from_numpy(fake))
    for got, ref in ((port_disc.discriminator_loss(p_real, p_fake, method), jax_disc.discriminator_loss(j_real, j_fake, method)),
                     (port_disc.generator_adversarial_loss(p_fake, method),
                      jax_disc.generator_adversarial_loss(j_fake, method)),
                     (port_disc.feature_matching_loss(p_real, p_fake), jax_disc.feature_matching_loss(j_real, j_fake))):
        assert abs(float(got) / float(ref) - 1) <= 1e-5, (float(got), float(ref))
    with pytest.raises(RuntimeError, match="unknown GAN loss method"):
        port_disc.discriminator_loss(p_real, p_fake, "wasserstein")


def _to64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)


def _port_gan(hp, gen_params, disc_params, dtype=torch.float64):
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"], trainable=True)
    model.block.load_state_dict(params_from_jax(flatten(gen_params)), strict=True)
    tr = AdversarialTrainer(model.to(dtype), hp, device="cpu")
    tr.discriminator.load_state_dict(params_from_jax(flatten(disc_params)), strict=True)
    return tr


def _gan_draws(jtr_base, key, shapes):
    """The draws of one JAX GAN step from `key`: train_step splits (r_d,
    r_g); the discriminator's training forward splits r_d into (rng,
    noise, floor); the generator loss draws as `Trainer.loss_fn` does."""
    r_d, r_g = jax.random.split(key)
    _, noise_rng, floor_rng = jax.random.split(r_d, 3)
    disc = {"noise": np.array(jax.random.normal(noise_rng, shapes["noise"], jnp.float32)),
            "floor": np.array(jax.random.uniform(floor_rng, shapes["floor"], minval=-1.0, maxval=1.0))}
    return jax_draws(jtr_base, r_g, shapes), disc


def test_gan_steps_match_jax_fp64(jax_init, monkeypatch):
    gen, disc = jax_init
    hp = _gan_hparams()
    batch = tiny_batch()
    keys = [jax.random.PRNGKey(10 + k) for k in range(GAN_STEPS)]
    monkeypatch.setenv("MBEXWN_PALLAS_WN", "0")  # the JAX Trainer sets it for the process; gone after the test
    with jax_in_fp64(monkeypatch):
        jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
        jtr = jax_adv.AdversarialTrainer(jmodel, copy.deepcopy(hp))
        g64, d64 = _to64(gen), _to64(disc)
        state = jax_adv.GANTrainState(gen=JaxTrainState(params=g64, opt_state=jtr.base.optimizer.init(g64),
                                                        step=jnp.int32(0)),
                                      disc_params=d64, disc_opt_state=jtr.disc_tx.init(d64))
        step_fn = jax.jit(jtr.train_step)
        jbatch = {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()}  # the discriminator step casts nothing
        j_metrics = []
        for key in keys:
            state, m = step_fn(state, jbatch, key)
            j_metrics.append({k: float(v) for k, v in m.items()})
        j_gen = params_from_jax({k: np.asarray(v) for k, v in flatten(state.gen.params).items()})
        j_disc = params_from_jax({k: np.asarray(v) for k, v in flatten(state.disc_params).items()})

    tr = _port_gan(hp, gen, disc)
    start_gen = {k: v.clone() for k, v in tr.base.model.block.state_dict().items()}
    start_disc = {k: v.clone() for k, v in tr.discriminator.state_dict().items()}
    shapes = tr.base.draw_shapes(batch)
    for key, j_m in zip(keys, j_metrics):
        draws, disc_draws = _gan_draws(jtr.base, key, shapes)
        m = {k: float(v) for k, v in tr.train_step(batch, draws, disc_draws).items()}
        assert m.keys() == j_m.keys() and {"adv_loss", "fm_loss", "disc_loss", "total_loss"} <= m.keys()
        worst = max((abs(m[k] / j_m[k] - 1), k) for k in m)
        print(f"GAN step {tr.step}: total {m['total_loss']:.15g} vs JAX {j_m['total_loss']:.15g}, disc "
              f"{m['disc_loss']:.15g} vs {j_m['disc_loss']:.15g}; worst metric {worst[1]} {worst[0]:.2e}")
        assert worst[0] <= 1e-10, worst
    rows = {}
    for what, got, start, ref in (("generator", tr.base.model.block.state_dict(), start_gen, j_gen),
                                  ("discriminator", tr.discriminator.state_dict(), start_disc, j_disc)):
        moved = {k: got[k] - start[k] for k in got}
        bad, rows[what] = hold_leaves(moved, {k: ref[k] - start[k] for k in got}, 1e-7)
        assert not bad, (what, bad)
        assert sum(float(v.abs().max()) > 0 for v in moved.values()) > len(moved) // 2, what
    print(", ".join(f"{w}: worst leaf {r[0][1]} {r[0][0]:.2e} of {len(r)}" for w, r in rows.items()))
    assert tr.step == GAN_STEPS


def test_one_generator_forward_per_generator_loss(jax_init, monkeypatch):
    """A GAN step runs the training forward twice: once without gradients
    for the discriminator's update, once for the generator's losses (the
    spectral and the adversarial terms share it); once without the
    discriminator."""
    gen, disc = jax_init
    for disable, expected in ((False, [False, True]), (True, [True])):
        tr = _port_gan(_gan_hparams(disable_discriminator=disable), gen, disc, torch.float32)
        calls = []
        real = Trainer.training_forward

        def counting(self, *a, **k):
            calls.append(torch.is_grad_enabled())
            return real(self, *a, **k)

        monkeypatch.setattr(Trainer, "training_forward", counting)
        tr.train_step(tiny_batch())
        monkeypatch.undo()
        assert calls == expected, (disable, calls)


def test_disable_discriminator_is_the_plain_step(jax_init):
    """With the discriminator disabled the GAN step is the spectral trainer's
    step, bit for bit; the discriminator does not move and disc_loss is 0."""
    gen, disc = jax_init
    hp = _gan_hparams(disable_discriminator=True)
    batch = tiny_batch()
    tr = _port_gan(hp, gen, disc, torch.float32)
    d0 = {k: v.clone() for k, v in tr.discriminator.state_dict().items()}
    plain = _port_gan(hp, gen, disc, torch.float32).base
    draws = {k: torch.randn(s, generator=torch.Generator().manual_seed(2)) for k, s in plain.draw_shapes(batch).items()}
    m = tr.train_step(batch, draws)
    ref = plain.train_step(batch, draws)
    assert float(m.pop("disc_loss")) == 0.0 and "adv_loss" not in m
    assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in ref.items()}
    got = tr.base.model.block.state_dict()
    assert all(torch.equal(v, got[k]) for k, v in plain.model.block.state_dict().items())
    assert all(torch.equal(v, tr.discriminator.state_dict()[k]) for k, v in d0.items())


def test_gan_card_against_cpu_rule_on_the_cpu():
    """The card check's rule (`gan_card_against_cpu`, run by the card test
    and chip_smoke.py [10](c)) with the CPU on both sides: the same step
    twice, every number equal."""
    failures, numbers = gan_card_against_cpu("cpu")
    assert not failures and numbers["worst_metric_rel"] == 0.0 and numbers["worst_leaf_rel_rms"] == 0.0
    assert numbers["leaves"] == 83 + 30 and {"adv_loss", "fm_loss", "disc_loss"} <= numbers["metrics"].keys()
