"""Adversarial trainer: the generator (MBExWN, through `Trainer`) and the
multi-scale discriminator.

Counterpart of the JAX package's training/adversarial.py, with the
wavegan_config contract: adv_loss_weight (0.1), fc_loss_weight (10),
disable_discriminator, discriminator_lr (2e-4, Adam b1 0.5, b2 0.9) and the
discriminator's loss_method (lsgan or hinge).  A step first updates the
discriminator on the generator's signal (its own draws, the generator's
forward without gradients), then the generator on its spectral losses plus
the adversarial and feature-matching losses against the updated
discriminator.  The generator's forward runs once per generator loss: its
signal feeds both the spectral and the adversarial losses.  (The JAX
package runs the training forward a second time for the adversarial terms,
with the same key, which gives the same signal.)

`train_step(batch, draws=None, disc_draws=None)`: `draws` are the
generator step's (`Trainer.draw_shapes`), `disc_draws` the discriminator
step's forward ("noise", "floor"); without them both come from the
generator's `torch.Generator` (seeded `seed`).
"""
from __future__ import annotations

from typing import Dict, Union

import torch

from ..ops.precision import exact_fp32
from .discriminator import (MultiScaleDiscriminator, discriminator_loss, feature_matching_loss,
                            generator_adversarial_loss)
from .trainer import Trainer


class AdversarialTrainer:
    def __init__(self, model, hparams: Dict, device: Union[str, torch.device] = "cuda", mesh=None, seed: int = 0):
        self.base = Trainer(model, hparams, device=device, mesh=mesh, seed=seed)
        self.device = self.base.device
        wg = hparams.get("wavegan_config", {}) or {}
        self.adv_loss_weight = wg.get("adv_loss_weight", 0.1)
        self.fc_loss_weight = wg.get("fc_loss_weight", 10.0)
        self.disable_discriminator = wg.get("disable_discriminator", False)
        disc_cfg = dict(wg.get("discriminator_config", {}) or {})
        self.loss_method = disc_cfg.pop("loss_method", "lsgan")
        disc_cfg.pop("n_group", None)
        disc_cfg.pop("activation", None)
        self.discriminator = MultiScaleDiscriminator(**disc_cfg)
        self.discriminator.init(torch.Generator().manual_seed(seed))
        self.discriminator.to(self.device, self.base.dtype)
        self.disc_params = list(self.discriminator.parameters())
        self.disc_optimizer = torch.optim.Adam(self.disc_params, lr=wg.get("discriminator_lr", 2e-4),
                                               betas=(0.5, 0.9), eps=1e-8)

    @property
    def step(self) -> int:
        return self.base.step

    def _set_disc_grad(self, on: bool) -> None:
        for p in self.disc_params:
            p.requires_grad_(on)

    def gen_loss(self, batch, step: int, draws=None):
        """(total, metrics): the spectral losses (`Trainer.loss_fn`) plus the
        adversarial and feature-matching losses of the same signal."""
        total, metrics, signal, target = self.base.loss_and_signal(batch, step, draws)
        if not self.disable_discriminator:
            fake_outs = self.discriminator(signal)
            real_outs = self.discriminator(target.detach())
            adv = generator_adversarial_loss(fake_outs, self.loss_method)
            fm = feature_matching_loss(real_outs, fake_outs)
            total = total + self.adv_loss_weight * adv + self.fc_loss_weight * fm
            metrics = dict(metrics, adv_loss=adv, fm_loss=fm, total_loss=total)
        return total, metrics

    def disc_loss(self, batch, step: int, draws=None) -> torch.Tensor:
        """The discriminator's loss on the generator's signal (computed
        without gradients) against the target audio."""
        b = self.base._batch(batch)
        with torch.no_grad():
            signal, target, _ = self.base.training_forward(b["audio"], b["mel"], b["F0"], step, draws,
                                                           F0_ds=b["F0_ds"])
        return discriminator_loss(self.discriminator(target), self.discriminator(signal), self.loss_method)

    def train_step(self, batch, draws=None, disc_draws=None) -> Dict[str, torch.Tensor]:
        """One discriminator update (unless disabled), then one generator
        update; returns the metrics (on the device), `disc_loss` among them."""
        if not self.disable_discriminator:
            self.disc_optimizer.zero_grad(set_to_none=True)
            with exact_fp32():
                d_loss = self.disc_loss(batch, self.base.step, disc_draws)
                d_loss.backward()
            self.disc_optimizer.step()
            d_loss = d_loss.detach()
        else:
            d_loss = torch.zeros((), device=self.device, dtype=self.base.dtype)
        self._set_disc_grad(False)
        try:
            _, metrics, _ = self.base.value_and_grad(batch, self.base.step, draws, loss=self.gen_loss)
        finally:
            self._set_disc_grad(True)
        self.base.apply_gradients()
        return dict(metrics, disc_loss=d_loss)
