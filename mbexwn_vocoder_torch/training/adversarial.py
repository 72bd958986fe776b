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

Data parallel (`group`): the generator's step is the `Trainer`'s.  The
discriminator starts from rank 0's parameters and its gradients are summed
over the ranks as one flat bucket.  Its LSGAN / hinge terms and the
feature-matching loss are batch means of per-sample terms (equal shapes,
no statistic across the batch), so the global batch's value is the mean of
the shards', assembled as the `Trainer` assembles its means
(`Trainer.globalise`), in the same all-reduce as the generator's terms.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
import torch.distributed as dist

from ..ops.precision import exact_fp32
from .discriminator import (MultiScaleDiscriminator, discriminator_loss, feature_matching_loss,
                            generator_adversarial_loss)
from .trainer import Trainer


class AdversarialTrainer:
    def __init__(self, model, hparams: Dict, device: Union[str, torch.device] = "cuda", seed: int = 0,
                 group: Optional[dist.ProcessGroup] = None):
        self.base = Trainer(model, hparams, device=device, seed=seed, group=group)
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
        self.base.broadcast(self.discriminator)
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
        means, sums, signal, target = self.base.loss_parts(batch, step, draws)
        if not self.disable_discriminator:
            fake_outs = self.discriminator(signal)
            real_outs = self.discriminator(target.detach())
            means["adv_loss"] = generator_adversarial_loss(fake_outs, self.loss_method)
            means["fm_loss"] = feature_matching_loss(real_outs, fake_outs)
        means, sums = self.base.globalise(means, sums)
        total, metrics = self.base.combine(means, sums, step)
        if not self.disable_discriminator:
            adv, fm = means["adv_loss"], means["fm_loss"]
            total = total + self.adv_loss_weight * adv + self.fc_loss_weight * fm
            metrics = dict(metrics, adv_loss=adv, fm_loss=fm, total_loss=total)
        return total, metrics

    def disc_loss(self, batch, step: int, draws=None) -> torch.Tensor:
        """The discriminator's loss on the generator's signal (computed
        without gradients) against the target audio, of the global batch
        under data parallelism."""
        b = self.base._batch(batch)
        with torch.no_grad():
            signal, target, _ = self.base.training_forward(b["audio"], b["mel"], b["F0"], step, draws,
                                                           F0_ds=b["F0_ds"])
        loss = discriminator_loss(self.discriminator(target), self.discriminator(signal), self.loss_method)
        return self.base.globalise({"disc_loss": loss}, {})[0]["disc_loss"]

    def train_step(self, batch, draws=None, disc_draws=None) -> Dict[str, torch.Tensor]:
        """One discriminator update (unless disabled), then one generator
        update; returns the metrics (on the device), `disc_loss` among them."""
        if not self.disable_discriminator:
            self.disc_optimizer.zero_grad(set_to_none=True)
            with exact_fp32():
                d_loss = self.disc_loss(batch, self.base.step, disc_draws)
                d_loss.backward()
            self.base.sync_gradients(self.disc_params)
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
