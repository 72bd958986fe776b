"""One training step: the training forward pass, the full loss, and an
optimizer that updates as the JAX package's optimizer chain does.

Counterpart of the JAX package's training/trainer.py.  `Trainer(model,
hparams, device="cuda")` takes a `PaNWaveNet` in its trainable form
(`create_model(..., trainable=True)`, `create_registry_model(...,
trainable=True)` or `model.trainable_()`) and sets it on the differentiable
route (`model.set_differentiable()`): the WaveNet stacks run layer by layer
and the oscillator runs `oscillate_plain`, the counterparts of the JAX
package's XLA route, which its trainer differentiates (it pins its Pallas
stack off).  The CUDA kernels stay the inference route; they have no
backward pass and raise where a gradient is asked of them.

With `remat_wavenet_blocks: true` in the model's config, each WaveNet block
is recomputed in the backward pass instead of keeping its activations
(models/mbexwn.py); the step's value and gradient are the same.

The random draws of a step (the noise channel, the excitation's noise
floor, the input dither and the loss's masking noises) are taken from
`draws`, a dict of tensors, when given (every draw the step needs must be
in it), else from the trainer's own `torch.Generator`, seeded with `seed`:

- "dither": standard normal of the audio's shape (training_config
  dither_level);
- "noise": standard normal (B, T_wn, 1), the WaveNet's noise channel;
- "floor": uniform in [-1, 1) of the padded excitation's shape
  (pulse_noise_floor_db);
- "rel_masking_noise", "masking_noise": standard normals of the target's
  shape (spect_loss_config rel_masking_noise_atten_db, masking_noise_std).

`draw_shapes(batch)` gives each needed draw's shape.

Data parallel (`group`, a `torch.distributed` process group, one process
per card, joined with `parallel.multihost.initialize`): every rank holds
the whole model, takes its contiguous share of each global batch (`batch`
is the rank's rows, B / world of them, the same count on every rank) and
the same rows of the global draws (given in `draws`, or drawn at the
global shape from the generator, which is seeded alike on every rank, and
sliced), and the parameters are broadcast from rank 0 when the trainer is
made.  The loss every rank reports, and differentiates, is the loss of the
global batch: each term of the loss is a batch mean of per-sample terms
or a ratio of batch sums (the F0 loss, whose weights count the voiced
frames, and the STFT coherence), so each rank computes its shard's means
and sums, one all-reduce of those numbers gives the batch's, and the loss
is assembled from them with each rank's own share kept differentiable
(`globalise`).  A rank's backward pass then gives its share of the global
gradient, and one all-reduce of all gradients, as one flat bucket, sums
the shares before the clipping sees them.  The step equals the
one-process step on the global batch up to the order of summation.  (A
mean of per-rank losses, DDP's rule, differs wherever a ratio couples the
samples.)

The optimizer is
`torch.optim` Adam, AdamW or SGD with momentum under a `LambdaLR` whose
factor reproduces the JAX package's learning-rate schedule (a linear warm-up
joined to a cosine, exponential or constant decay that restarts its count
at the boundary; update k uses the schedule at k, counted from 0), after
global-norm clipping as the JAX package computes it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

from ..ops.precision import exact_fp32
from ..ops.stft_ops import istft, stft
from ..platform import resolve_device
from .losses import (SpectLossComponents, f0_pred_loss_mask, f0_prediction_loss_parts, f0_rec_loss_mask,
                     finish_f0_prediction_loss, stft_coherence_loss_parts, td_loss)
from .schedules import ParamSchedule


def lr_schedule(training_config: Dict):
    """(base learning rate, schedule: update count -> learning rate), the
    learning rate of the JAX package's `_make_optimizer`."""
    opt_cfg = training_config.get("optimizer", {}) or {}
    if isinstance(opt_cfg, str):
        opt_cfg = {"type": opt_cfg}
    lr = float(opt_cfg.get("learning_rate", training_config.get("learning_rate", 1e-4)))
    sched = training_config.get("lr_schedule")
    if not sched:
        return lr, lambda count: lr
    stype = str(sched.get("type", "cosine")).lower()
    warmup = sched.get("warmup_steps", 0)
    decay = sched.get("decay_steps", 1_000_000)
    final = sched.get("final_scale", 0.01)
    if stype == "cosine":
        def main(count):
            count = min(count, decay)
            return lr * ((1 - final) * 0.5 * (1 + math.cos(math.pi * count / decay)) + final)
    elif stype == "exponential":
        def main(count):
            return lr * final ** (count / decay)
    else:
        def main(count):
            return lr
    if not warmup:
        return lr, main

    def joined(count):
        # joined schedules: the one after the boundary restarts its count at 0
        if count < warmup:
            return (0.0 - lr) * (1 - count / warmup) + lr  # the linear warm-up from 0 to lr
        return main(count - warmup)
    return lr, joined


def make_optimizer(params, training_config: Dict):
    """(torch.optim optimizer, LambdaLR) of the JAX package's `_make_optimizer`
    (without its clipping: `clip_by_global_norm_`)."""
    opt_cfg = training_config.get("optimizer", {}) or {}
    if isinstance(opt_cfg, str):
        opt_cfg = {"type": opt_cfg}
    lr, schedule = lr_schedule(training_config)
    betas = (opt_cfg.get("beta1", 0.9), opt_cfg.get("beta2", 0.999))
    opt_type = str(opt_cfg.get("type", "adam")).lower()
    if opt_type == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8)
    elif opt_type == "adamw":
        # decoupled decay scaled by the learning rate, as in the JAX package's AdamW
        opt = torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8,
                                weight_decay=opt_cfg.get("weight_decay", 1e-4))
    elif opt_type == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=opt_cfg.get("momentum", 0.9))
    else:
        raise RuntimeError(f"unknown optimizer type {opt_type}")
    scheduler = torch.optim.lr_scheduler.LambdaLR(opt, lambda count: schedule(count) / lr)
    return opt, scheduler


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """The JAX package's global-norm clipping, in place: every gradient becomes
    (g / norm) * max_norm where the global norm is >= max_norm, and stays as
    it is below.  (`clip_grad_norm_` divides by norm + 1e-6.)  Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


def fast_forward_opt_state(trainer, step: int) -> None:
    """Set every optimizer-internal step counter to `step`: each parameter's
    Adam/AdamW `step` (its moments are created at zero if the optimizer has
    not stepped yet) and the learning-rate schedule's count, as the JAX
    package's `fast_forward_opt_state` sets its optimizer's step counts.  SGD
    keeps no count.  `trainer` is anything with `optimizer` and `scheduler`."""
    opt, scheduler = trainer.optimizer, trainer.scheduler
    if isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
        for group in opt.param_groups:
            for p in group["params"]:
                state = opt.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["step"] = torch.tensor(float(step), dtype=torch.float32)
    scheduler.last_epoch = step
    for group, lr in zip(opt.param_groups, [base * fn(step) for base, fn in zip(scheduler.base_lrs,
                                                                               scheduler.lr_lambdas)]):
        group["lr"] = lr
    scheduler._last_lr = [group["lr"] for group in opt.param_groups]


class Trainer:
    def __init__(self, model, hparams: Dict, device: Union[str, torch.device] = "cuda", seed: int = 0,
                 group: Optional[dist.ProcessGroup] = None):
        self.device = resolve_device(device)
        self.group = group
        self.world = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        if not model.trainable:
            raise ValueError("Trainer: the model is in its folded (inference) form; build it trainable "
                             "(create_model(..., trainable=True)) or call model.trainable_()")
        mc = model.model_config
        self.model = model.to(self.device).train()
        model.set_differentiable(True)
        self.hparams = hparams
        self.training_config = hparams["training_config"]
        self.preprocess_config = hparams["preprocess_config"]
        self.spect_losses = SpectLossComponents(self.training_config, self.preprocess_config)
        self.params = list(model.parameters())
        self.dtype = self.params[0].dtype  # float32; a float64 model is a reference for the fp32 rounding
        self.optimizer, self.scheduler = make_optimizer(self.params, self.training_config)
        self.grad_clip_norm = self.training_config.get("grad_clip_norm")
        self.step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(seed)  # the draws without `draws`

        blk = model.block
        self.F0_down = blk.F0_down_sampling_factor
        self.pulse_rate = blk.pulse_rate
        self.pp_F0_loss_weight = None
        if mc.get("pp_F0_loss_weight") is not None:
            w = mc["pp_F0_loss_weight"]
            self.pp_F0_loss_weight = (ParamSchedule(name="pp_F0_loss_weight", **w) if isinstance(w, dict)
                                      else ParamSchedule(name="pp_F0_loss_weight", initial=w))
        self.pp_F0_loss_method = mc.get("pp_F0_loss_method", "L1")
        self.pp_F0_UV_loss_weight = mc.get("pp_F0_UV_loss_weight")
        self.pred_limit = int((mc.get("pp_F0_pred_loss_limits_ms", 0.0) * self.pulse_rate) // 1000)
        self.rec_limit = int((max(mc.get("pp_F0_rec_loss_limits_ms", 0.0), 0.0) * self.pulse_rate) // 1000)
        tf_sched = mc.get("pp_teacher_forcing_schedule")
        self.teacher_forcing = ParamSchedule(name="pp_teacher_forcing_schedule", **tf_sched) if tf_sched else None
        self.pp_min_frequency = mc.get("pp_min_frequency", 40.0)
        self.suppress_uv_gradient = mc.get("pp_subnet_suppress_uv_gradient", False)
        self.stft_coh_loss_weight = mc.get("stft_coh_loss_weight")
        self.pulse_noise_floor_mag = blk.pulse_noise_floor_mag
        self.dither_level = self.training_config.get("dither_level", 0) or 0
        self.TD_loss_weight = self.training_config.get("TD_loss_weight", 0) or 0
        self.TD_loss_win_len = self.training_config.get("TD_loss_win_len", 512)
        self.broadcast(self.model)

    # ------------------------------------------------------- data parallel

    def broadcast(self, module: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers of `module` on every rank (nothing
        without a group)."""
        if self.group is None:
            return
        src = dist.get_global_rank(self.group, 0)
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=src, group=self.group)

    def globalise(self, means: Dict[str, torch.Tensor], sums: Dict[str, torch.Tensor]):
        """The global batch's batch means and batch sums from this rank's, in
        one all-reduce: each has the global value and this rank's gradient
        (x + (global - x).detach(), x its share), so that the gradients of
        all ranks sum to the gradient of the global loss.  A mean's share is
        the shard's mean over the world size.  Without a group, the
        arguments."""
        if self.group is None:
            return means, sums
        means = {k: v / self.world for k, v in means.items()}
        names = list(means) + list(sums)
        local = {**means, **sums}
        flat = torch.stack([local[k].detach().to(self.dtype) for k in names])
        dist.all_reduce(flat, group=self.group)
        out = {k: local[k] + (flat[i] - local[k]).detach() for i, k in enumerate(names)}
        return {k: out[k] for k in means}, {k: out[k] for k in sums}

    def sync_gradients(self, params) -> None:
        """Sum the gradients of `params` over the ranks, as one flat bucket
        (nothing without a group); a parameter without a gradient takes part
        with zeros."""
        if self.group is None:
            return
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset: offset + g.numel()].view_as(g))
            offset += g.numel()

    def _rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor of the global batch."""
        if self.group is None:
            return t
        n = t.shape[0] // self.world
        return t[self.rank * n: (self.rank + 1) * n]

    # ---------------------------------------------------------------- draws

    def draw_shapes(self, batch) -> Dict[str, Tuple[int, ...]]:
        """The shape of each draw a step on `batch` takes (module docstring),
        at the global batch's size under data parallelism."""
        blk = self.model.block
        B, T = batch["audio"].shape[:2]
        B *= self.world
        T_mel = batch["mel"].shape[1]
        shapes = {}
        if self.dither_level:
            shapes["dither"] = (B, T)
        if blk.pp_mod_subnet_noise_channel_sigma:
            shapes["noise"] = (B, blk.wn_input_length(T_mel), 1)
        if self.pulse_noise_floor_mag is not None:
            shapes["floor"] = (B, T_mel * blk.spect_hop_size + blk.stft_win_size + blk.spect_hop_size + 1)
        target = (B, min(T, T_mel * blk.spect_to_pulse_upsampling_factor * blk.F0_down_sampling_factor))
        for name in self.spect_losses.masking_draws:
            shapes[name] = target
        return shapes

    def _draw(self, draws, name: str, shape) -> torch.Tensor:
        """This rank's rows of the draw `name`; `shape` is the rank's."""
        shape = (shape[0] * self.world,) + tuple(shape[1:])
        if draws is not None:
            t = torch.as_tensor(draws[name])
            if tuple(t.shape) != shape:
                raise ValueError(f"draw {name!r} has shape {tuple(t.shape)}, the step needs {shape}")
            return self._rows(t).to(self.device, self.dtype)
        if name == "floor":
            t = torch.rand(shape, generator=self.generator, device=self.device, dtype=self.dtype) * 2.0 - 1.0
        else:
            t = torch.randn(shape, generator=self.generator, device=self.device, dtype=self.dtype)
        return self._rows(t)

    # ------------------------------------------------------ training forward

    def _batch(self, batch) -> Dict[str, Optional[torch.Tensor]]:
        return {k: None if batch.get(k) is None else torch.as_tensor(batch[k]).to(self.device, self.dtype)
                for k in ("audio", "mel", "F0", "F0_ds")}

    def training_forward(self, audio, mel, F0, step: int, draws=None, F0_ds=None):
        """Training-mode forward: (signal, target audio, aux losses), as the
        JAX package's `training_forward`; `F0_ds` is the pulse-rate F0 target,
        which replaces striding the sample-rate `F0`.  The aux losses (F0,
        STFT coherence) are given as (numerator, denominator) batch sums."""
        model, blk, aux = self.model, self.model.block, {}
        if model.norm_mel_components is not None:
            grp_audio, mel_in, _ = model.norm_mel_components.normalize_inputs_by_rms(audio[:, :, None], mel)
            target_audio = grp_audio[:, :, 0]
        else:
            mel_in, target_audio = mel, audio

        pulse_frequency = blk.generate_f0(mel_in)
        if F0_ds is None:
            F0_ds = F0[:, :: self.F0_down] if F0 is not None else None
        pred_mask = rec_mask = None
        if F0_ds is not None:
            t = F0_ds[:, :, 0] if F0_ds.dim() == 3 else F0_ds
            pred_mask = f0_pred_loss_mask(t, self.pred_limit)
            rec_mask = f0_rec_loss_mask(t, self.rec_limit)
            if self.pp_F0_loss_weight is not None:
                aux["F0_loss"] = f0_prediction_loss_parts(pulse_frequency, t, pred_mask,
                                                          method=self.pp_F0_loss_method,
                                                          uv_weight=self.pp_F0_UV_loss_weight, rec_mask=rec_mask,
                                                          min_frequency=self.pp_min_frequency)

        # teacher forcing: the target F0 inside confidently voiced segments, blended by schedule
        if self.teacher_forcing is not None and F0_ds is not None:
            t = F0_ds[:, :, 0] if F0_ds.dim() == 3 else F0_ds
            ext = t * pred_mask + (1 - pred_mask) * pulse_frequency[:, : t.shape[1]]
            ext = torch.cat((ext, ext[:, -1:].expand(-1, pulse_frequency.shape[1] - ext.shape[1])), dim=1)
            w = self.teacher_forcing(step)
            pf = pulse_frequency * (1 - w) + ext * w
            if self.suppress_uv_gradient:
                rme = torch.nn.functional.pad(rec_mask, (0, pf.shape[1] - rec_mask.shape[1]))
                pf = rme * pf + ((1 - rme) * pf).detach()
        else:
            pf = pulse_frequency

        noise = self._draw(draws, "noise", (pf.shape[0], blk.wn_input_length(mel_in.shape[1]), 1)) \
            if blk.pp_mod_subnet_noise_channel_sigma else None
        excitation = blk.generate_excitation(mel_in, pf, noise=noise)
        win, hop = blk.stft_win_size, blk.spect_hop_size
        padded = torch.nn.functional.pad(excitation, (win // 2, win // 2 + hop + 1))
        if self.pulse_noise_floor_mag is not None:
            # dither against zero magnitudes, whose gradients are NaN
            padded = padded + self.pulse_noise_floor_mag * self._draw(draws, "floor", padded.shape)
        source_stft = stft(padded, win, hop, blk.fft_size, blk.stft_window)[:, : mel_in.shape[1]]
        source_filter_stft, env_aux = blk.generate_specenv(mel_in, pf.detach(), training=True)
        aux.update(env_aux)
        signal = istft(source_stft * source_filter_stft, win, hop, blk.fft_size, blk.istft_window)
        signal = signal[:, win // 2: win // 2 + pulse_frequency.shape[1] * blk.F0_down_sampling_factor]
        if self.stft_coh_loss_weight:
            aux["stft_coh_loss"] = stft_coherence_loss_parts(source_stft.detach() * source_filter_stft, win, hop,
                                                             blk.fft_size, blk.istft_window, blk.stft_window)
        T = min(signal.shape[1], target_audio.shape[1])
        return signal[:, :T], target_audio[:, :T], aux

    # ------------------------------------------------------------- loss/step

    def loss_fn(self, batch, step: Optional[int] = None, draws=None):
        """(total loss, metrics) of the model's current parameters on `batch`
        (audio (B, T), mel (B, T_mel, C), F0 (B, T) or F0_ds), as the JAX
        package's `Trainer.loss_fn`."""
        total, metrics, _, _ = self.loss_and_signal(batch, step, draws)
        return total, metrics

    def loss_and_signal(self, batch, step: Optional[int] = None, draws=None):
        """`loss_fn`'s (total, metrics) and the training forward's (signal,
        target) they were computed from."""
        step = self.step if step is None else step
        means, sums, signal, target = self.loss_parts(batch, step, draws)
        total, metrics = self.combine(*self.globalise(means, sums), step)
        return total, metrics, signal, target

    def loss_parts(self, batch, step: int, draws=None):
        """The loss's terms on this rank's batch: (batch means, batch sums,
        signal, target), the sums as "<term>/num" and "<term>/den"."""
        b = self._batch(batch)
        audio = b["audio"]
        with exact_fp32():
            if self.dither_level:
                audio = audio + self.dither_level * self._draw(draws, "dither", audio.shape)
            signal, target, aux = self.training_forward(audio, b["mel"], b["F0"], step, draws, F0_ds=b["F0_ds"])
            noises = {name: self._draw(draws, name, target.shape) for name in self.spect_losses.masking_draws}
            means = {k: v for k, v in self.spect_losses.calc_losses(target, signal, noises=noises).items()
                     if v is not None}
            if self.TD_loss_weight:
                means["TD_loss"] = td_loss(signal, target, self.TD_loss_win_len)
        sums = {}
        for name, on in (("F0_loss", self.pp_F0_loss_weight is not None), ("stft_coh_loss", self.stft_coh_loss_weight)):
            if name in aux and on:
                sums[f"{name}/num"], sums[f"{name}/den"] = aux[name]
        return means, sums, signal, target

    def combine(self, means: Dict[str, torch.Tensor], sums: Dict[str, torch.Tensor], step: int):
        """(total loss, metrics) from the batch's means and sums: the
        weighted terms, as the JAX package's `Trainer.loss_fn` adds them."""
        total = self.spect_losses.combine({k: means.get(k) for k in ("spect_loss", "mel_loss", "NPOW_loss")}, step,
                                          self.device)
        metrics = {k: means[k] for k in ("mel_loss", "spect_loss", "NPOW_loss") if k in means}
        if "TD_loss" in means:
            metrics["TD_loss"] = means["TD_loss"]
            total = total + self.TD_loss_weight * means["TD_loss"]
        if "F0_loss/num" in sums:
            metrics["F0_loss"] = finish_f0_prediction_loss(sums["F0_loss/num"], sums["F0_loss/den"],
                                                           self.pp_F0_loss_method, self.pp_F0_UV_loss_weight)
            total = total + metrics["F0_loss"] * self.pp_F0_loss_weight(step)
        if "stft_coh_loss/num" in sums:
            metrics["stft_coh_loss"] = sums["stft_coh_loss/num"] / sums["stft_coh_loss/den"]
            total = total + metrics["stft_coh_loss"] * self.stft_coh_loss_weight
        metrics["total_loss"] = total
        return total, metrics

    def value_and_grad(self, batch, step: Optional[int] = None, draws=None, loss=None):
        """(loss, metrics, {state_dict key: gradient}), the counterpart of
        `jax.value_and_grad(Trainer.loss_fn)`: of the global batch under data
        parallelism.  The gradients stay in the
        parameters' `.grad` too; a parameter the loss does not reach gets a
        zero gradient, as in JAX.  `loss(batch, step, draws) -> (total,
        metrics)` replaces `loss_fn` (the adversarial generator loss)."""
        self.optimizer.zero_grad(set_to_none=True)
        with exact_fp32():  # the backward pass's fp32 products too
            total, metrics = (loss or self.loss_fn)(batch, step, draws)
            total.backward()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.sync_gradients(self.params)
        grads = {name: p.grad for name, p in self.model.block.named_parameters()}
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def apply_gradients(self) -> None:
        """Clip the gradients in `.grad`, take one optimizer and one schedule
        step and count the step."""
        if self.grad_clip_norm:
            clip_by_global_norm_(self.params, self.grad_clip_norm)
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1

    def train_step(self, batch, draws=None) -> Dict[str, torch.Tensor]:
        """One backward pass and one optimizer step; returns the metrics (on
        the device, not synchronised)."""
        _, metrics, _ = self.value_and_grad(batch, self.step, draws)
        self.apply_gradients()
        return metrics
