"""Activation pretraining: calibrate the weight-norm gains, the biases and
the PReLU slopes so that every conv's output statistics hit a target scale
before training starts.

Counterpart of the JAX package's training/pretrain.py.  The pretrainable
weights are those whose JAX leaf name (`compat.params_io.jax_path`) is `g`,
`b` or `alpha`; an Adam over them alone moves them while every other weight
stays bit for bit as it was, as the JAX package's masked optimizer leaves
its frozen leaves.  The loss differentiates through the F0 net, the
oscillator and both WaveNets, so it runs on the differentiable route (the
CUDA kernels have no backward pass); the model's route is set back
afterwards.  The noise channel's draw of each iteration is injectable
(`noises`), else taken from a generator seeded 0.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..compat.params_io import jax_path
from ..ops.precision import exact_fp32
from ..ops.wavenet_stack import gate

_PRETRAINABLE_LEAVES = ("g", "b", "alpha")

Stats = List[Tuple[str, torch.Tensor, torch.Tensor]]


def pretrainable_mask(model) -> Dict[str, bool]:
    """{parameter name: pretrainable}: True for the JAX leaves g, b and alpha."""
    return {name: jax_path(name).rsplit("/", 1)[-1] in _PRETRAINABLE_LEAVES
            for name, _ in model.block.named_parameters()}


def _layer_stats(act: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(batch-wise mean, mean abs deviation) of an activation map."""
    axes = tuple(range(1, act.dim()))
    ma = act.mean(dim=axes, keepdim=True)
    dev = (act - ma).abs().mean(dim=axes)
    return ma.reshape(act.shape[0]), dev


def collect_subnet_stats(seq, x) -> Stats:
    """Run a Sequential subnet, capturing each conv layer's output stats."""
    stats = []
    for layer in seq.children():
        x = layer(x)
        if type(layer).__name__.startswith("Conv1D"):
            stats.append((layer.name, *_layer_stats(x)))
    return stats


def collect_wavenet_stats(wn, audio_0: torch.Tensor, spect: torch.Tensor) -> Stats:
    """Stats of the start, conditioning, dilated, res/skip and end convs of
    a WaveNetAE, run layer by layer in the input's dtype."""
    started = wn.start(audio_0)
    stats = [("start", *_layer_stats(started))]
    cond = wn.cond(spect)
    stats.append(("cond", *_layer_stats(cond)))
    cond = wn.cond_linup(cond)
    C, out = wn.n_channels, None
    for i in range(wn.n_layers):
        conv, rs_layer = getattr(wn, f"conv1D_{i}"), getattr(wn, f"res_skip_{i}")
        y = conv(started)
        stats.append((conv.name, *_layer_stats(y)))
        y = y + cond
        rs = rs_layer(gate(wn.activation, y[..., :C], y[..., C:]))
        stats.append((rs_layer.name, *_layer_stats(rs)))
        if i < wn.n_layers - 1:
            started = started + rs[..., :C]
            rs = rs[..., C:]
        out = rs if out is None else out + rs
    stats.append(("end", *_layer_stats(wn.end(out))))
    return stats


def activation_stats_loss(model, mel: torch.Tensor, target: float = 1.0, noise: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None):
    """(mean over layers of mean^2 + (abs_dev - target)^2, {layer name: its
    term}); a name that occurs twice (both WaveNets have a "start") keeps
    the later term in the dict, as in the JAX package, while the loss sums
    all.  `noise` (or `generator`) feeds the noise channel."""
    blk = model.block
    all_stats = []
    if blk.pp_subnet is not None:
        all_stats += collect_subnet_stats(blk.pp_subnet, mel)
    if getattr(blk, "ps_subnet", None) is not None:
        all_stats += collect_subnet_stats(blk.ps_subnet, mel)
    x = blk.fold_pulse_channels(blk.oscillate(blk.generate_f0(mel)), noise=noise, generator=generator)
    for name in blk.block_names:
        bl = getattr(blk, name)
        all_stats += collect_wavenet_stats(bl.wavenet, x, mel)
        x = bl(x, mel)
    x = blk.wn_post_net(x)
    all_stats.append(("wn_post_net", *_layer_stats(x)))

    loss = torch.zeros((), dtype=mel.dtype, device=mel.device)
    per_layer = {}
    for name, m, d in all_stats:
        term = torch.mean(torch.square(m)) + torch.mean(torch.square(d - target))
        per_layer[name] = term
        loss = loss + term
    return loss / max(len(all_stats), 1), per_layer


def pretrain_activations(model, mels: Sequence, target: float = 1.0, max_iters: int = 100, lr: float = 1e-2,
                         to_rmse: float = 0.05, noises: Optional[Sequence] = None) -> float:
    """Optimize only {g, bias, alpha} (Adam, `lr`) until the stats loss is
    below to_rmse^2 or `max_iters` iterations ran, in place.  `mels` are the
    calibration batches, taken in turn; `noises[i]` is iteration i's noise
    channel draw (without `noises`, a generator seeded 0 draws them).
    Returns the loss of the last iteration (before its update), as the JAX
    package does."""
    blk = model.block
    params = dict(blk.named_parameters())
    mask = pretrainable_mask(model)
    dev, dtype = next(iter(params.values())).device, next(iter(params.values())).dtype
    routes = {m: m.differentiable for m in blk.modules() if hasattr(m, "differentiable")}
    requires = {name: p.requires_grad for name, p in params.items()}
    opt = torch.optim.Adam([p for name, p in params.items() if mask[name]], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    generator = torch.Generator(device=dev).manual_seed(0) if noises is None else None
    loss = float("inf")
    try:
        model.set_differentiable(True)
        for name, p in params.items():
            p.requires_grad_(mask[name])
        for it in range(max_iters):
            mel = torch.as_tensor(mels[it % len(mels)]).to(dev, dtype)
            noise = None if noises is None else torch.as_tensor(noises[it]).to(dev, dtype)
            opt.zero_grad(set_to_none=True)
            with exact_fp32():
                value, _ = activation_stats_loss(model, mel, target, noise=noise, generator=generator)
                value.backward()
            for name, p in params.items():
                if mask[name] and p.grad is None:
                    p.grad = torch.zeros_like(p)  # a leaf the loss does not reach: a zero gradient, as in JAX
            opt.step()
            loss = float(value.detach())
            if loss < to_rmse ** 2:
                break
    finally:
        for name, p in params.items():
            p.requires_grad_(requires[name])
            p.grad = None
        for m, on in routes.items():
            m.differentiable = on
    return loss
