"""Multi-scale waveform discriminator for adversarial training, and the GAN
losses.

Counterpart of the JAX package's training/discriminator.py.  Per scale, a
stack of weight-normalised convs (kernel 15, the down-sampling ones with
stride 4, TF SAME padding) with LeakyReLU 0.2, returning the logits and the
feature maps of the feature-matching loss; each scale after the first sees
the waveform average-pooled by 2 once more.  The convs are the port's
`Conv1DWeightNorm` in the trainable form (`v`, `g`, `bias`), initialised as
the JAX package initialises them; the state_dict is the JAX tree
scale_i/{pre,down_j,post,out}/{v,g,b} under `compat.params_io`'s names.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import Conv1DWeightNorm

Outs = List[Tuple[torch.Tensor, List[torch.Tensor]]]


class ScaleDiscriminator(nn.Module):
    """One scale: conv stack over (B, T, 1) waveforms -> (logits, features)."""

    def __init__(self, n_layers: int = 5, base_channels: int = 16, max_channels: int = 256,
                 kernel_size: int = 15, stride: int = 4, name: str = "disc_scale"):
        super().__init__()
        self.name = name
        ch = base_channels
        self.layer_names = ["pre"]
        self.add_module("pre", Conv1DWeightNorm(1, ch, kernel_size, padding="SAME", name="pre"))
        for i in range(n_layers - 1):
            ch_out = min(ch * stride, max_channels)
            self.add_module(f"down_{i}", Conv1DWeightNorm(ch, ch_out, kernel_size, strides=stride, padding="SAME",
                                                          name=f"down_{i}"))
            self.layer_names.append(f"down_{i}")
            ch = ch_out
        self.post = Conv1DWeightNorm(ch, ch, 5, padding="SAME", name="post")
        self.out = Conv1DWeightNorm(ch, 1, 3, padding="SAME", name="out")
        for m in self.modules():
            if isinstance(m, Conv1DWeightNorm):
                m.trainable_()

    def forward(self, x: torch.Tensor):
        feats = []
        for name in self.layer_names:
            x = F.leaky_relu(getattr(self, name)(x), 0.2)
            feats.append(x)
        x = F.leaky_relu(self.post(x), 0.2)
        feats.append(x)
        return self.out(x), feats


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """Stride-2 average pooling over time for the multi-scale pyramid (an odd
    last sample is dropped)."""
    T = x.shape[1] - (x.shape[1] % 2)
    x = x[:, :T]
    return 0.5 * (x[:, 0::2] + x[:, 1::2])


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, n_scales: int = 3, name: str = "msd", **scale_kwargs):
        super().__init__()
        self.name = name
        self.scale_names = [f"scale_{i}" for i in range(n_scales)]
        for sname in self.scale_names:
            self.add_module(sname, ScaleDiscriminator(name=sname, **scale_kwargs))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "MultiScaleDiscriminator":
        """The JAX package's initialisation, drawn from `generator`: glorot
        uniform v, g = ||v|| per channel, zero bias."""
        for m in self.modules():
            if isinstance(m, Conv1DWeightNorm):
                m.init(generator)
        return self

    def forward(self, audio: torch.Tensor) -> Outs:
        """audio: (B, T) -> list over scales of (logits, features)."""
        x = audio[:, :, None]
        outs = []
        for sname in self.scale_names:
            outs.append(getattr(self, sname)(x))
            x = _avg_pool2(x)
        return outs


# ------------------------------------------------------------------- losses


def discriminator_loss(real_outs: Outs, fake_outs: Outs, method: str = "lsgan") -> torch.Tensor:
    """Per the wavegan loss_method key: lsgan (least_squares) or hinge."""
    loss = 0.0
    for (real_logits, _), (fake_logits, _) in zip(real_outs, fake_outs):
        if method in ("lsgan", "least_squares"):
            loss = loss + torch.mean(torch.square(real_logits - 1.0)) + torch.mean(torch.square(fake_logits))
        elif method == "hinge":
            loss = loss + torch.mean(torch.relu(1.0 - real_logits)) + torch.mean(torch.relu(1.0 + fake_logits))
        else:
            raise RuntimeError(f"unknown GAN loss method {method}")
    return loss / len(real_outs)


def generator_adversarial_loss(fake_outs: Outs, method: str = "lsgan") -> torch.Tensor:
    loss = 0.0
    for fake_logits, _ in fake_outs:
        if method in ("lsgan", "least_squares"):
            loss = loss + torch.mean(torch.square(fake_logits - 1.0))
        elif method == "hinge":
            loss = loss - torch.mean(fake_logits)
        else:
            raise RuntimeError(f"unknown GAN loss method {method}")
    return loss / len(fake_outs)


def feature_matching_loss(real_outs: Outs, fake_outs: Outs) -> torch.Tensor:
    loss, n = 0.0, 0
    for (_, real_feats), (_, fake_feats) in zip(real_outs, fake_outs):
        for rf, ff in zip(real_feats, fake_feats):
            loss = loss + torch.mean(torch.abs(rf - ff))
            n += 1
    return loss / max(n, 1)
