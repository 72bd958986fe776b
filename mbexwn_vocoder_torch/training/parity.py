"""The tiny training case that the parity checks share, and their per-leaf
gradient rule.

The case is SPEECH with a 16-channel, 2-layer WaveNet, F0 loss, teacher
forcing 0.5 and STFT coherence 0.1, T_mel = 8, batch 2.  The CPU tests hold
the port's loss and gradients on it against the JAX package's; the card
test and `chip_smoke.py` phase [9](b) hold the card's against the CPU's,
and phase [10](c) does the same for one adversarial step (`TINY_WAVEGAN`,
a small discriminator).

Gradients are compared leaf by leaf as rel-RMS (`hold_leaves`); a leaf
whose norm is under 1e-6 of the largest is held to 1e-7 absolute instead.
The tight comparisons are made in fp64.  In fp32 the gradient of this loss
on a randomly initialised model is only determined to 1e-3 - 1e-2 rel-RMS,
depending on the init, on the CPU as on the card and in the JAX package:
the log-spectral L1 loss and the F0 gradient through the oscillator's
table lookup both turn fp32 rounding into errors of that size.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple, Union

import numpy as np
import torch

TINY_T_MEL, TINY_BATCH, TINY_HOP = 8, 2, 300
TINY_WAVEGAN = {"adv_loss_weight": 0.1, "fc_loss_weight": 2.0,
                "discriminator_config": {"loss_method": "lsgan", "n_scales": 2, "n_layers": 3, "base_channels": 4,
                                         "max_channels": 16}}

def tiny_hparams(**edits) -> Dict:
    """SPEECH's hparams cut to the tiny case; `edits` are {"section.key":
    value} overrides."""
    from .. import get_config_file
    from ..config import read_config

    hp = read_config(get_config_file("SPEECH"))
    mc = hp["mbexwn_config"]
    mc["pp_mod_subnet"].update(n_channels=16, n_layers=2, n_out_channels=8)
    mc.update(normalize_rms_from_mell=False, pp_F0_loss_weight=1.0, pp_teacher_forcing_schedule={"initial": 0.5},
              stft_coh_loss_weight=0.1)
    for key, value in edits.items():
        section, name = key.split(".")
        hp[section][name] = value
    return hp


def tiny_batch(seed: int = 1) -> Dict[str, np.ndarray]:
    """Noise-like audio and mel, and an F0 around 120 Hz with unvoiced
    stretches (so both F0 masks have edges inside the segment)."""
    rng = np.random.RandomState(seed)
    T = TINY_T_MEL * TINY_HOP
    f0 = (120 + 10 * rng.randn(TINY_BATCH, T)).astype(np.float32)
    f0[0, 600:1100] = 0.0
    f0[1, 1800:] = 0.0
    return {"audio": (rng.randn(TINY_BATCH, T) * 0.1).astype(np.float32),
            "mel": (rng.randn(TINY_BATCH, TINY_T_MEL, 80) * 0.5 - 4).astype(np.float32), "F0": f0}


def rel_rms(got, ref) -> float:
    """||got - ref|| / ||ref|| in fp64, for tensors or arrays."""
    got, ref = (np.asarray(x.detach().cpu().double() if torch.is_tensor(x) else x, np.float64) for x in (got, ref))
    return float(np.sqrt(np.sum((got - ref) ** 2) / max(np.sum(ref ** 2), 1e-300)))


def hold_leaves(got: Dict, ref: Dict, bound: Union[float, Callable[[str], float]]
                ) -> Tuple[List[Tuple[str, float, float]], List[Tuple[float, str, float]]]:
    """Gradients `got` against `ref`, leaf by leaf: rel-RMS <= bound (a
    number, or a function of the leaf's name); a leaf whose norm is under
    1e-6 of the largest within 1e-7 absolute.  Returns the failing leaves
    (name, error, bound) and every leaf's (error, name, bound), worst first."""
    if set(got) != set(ref):
        raise KeyError(f"leaves differ: {sorted(set(got) ^ set(ref))}")
    bound_of = bound if callable(bound) else (lambda _: bound)
    largest = max(float(torch.as_tensor(r).double().norm()) for r in ref.values())
    rows = []
    for name, r in ref.items():
        g, r = (torch.as_tensor(x).detach().cpu().double() for x in (got[name], r))
        if float(r.norm()) < 1e-6 * largest:
            rows.append((float((g - r).abs().max()), name, 1e-7))
        else:
            rows.append((rel_rms(g, r), name, bound_of(name)))
    rows.sort(reverse=True)
    return [(name, err, b) for err, name, b in rows if not err <= b], rows


def card_against_cpu(device, seed: int = 0) -> Tuple[List[str], Dict]:
    """The tiny case's loss and gradients on `device` against the CPU's,
    from one init (the port's, seeded) and one set of draws: in fp64 the
    loss within 1e-12 relative and every leaf within 1e-9 rel-RMS; in fp32
    the loss within 1e-5.  The fp32 gradients of both devices are reported
    against the CPU's fp64 ones (module docstring).  Returns (failures,
    numbers)."""
    from ..models import create_model
    from .trainer import Trainer

    hp = tiny_hparams()
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"], trainable=True)
    model.init(torch.Generator().manual_seed(seed))
    state = {k: v.clone() for k, v in model.block.state_dict().items()}
    batch = tiny_batch()
    out = {}
    for label, dev in (("cpu", "cpu"), ("device", device)):
        for dtype in (torch.float32, torch.float64):
            m, _ = create_model(hp, hp["training_config"], hp["preprocess_config"], trainable=True)
            m.block.load_state_dict(state)
            tr = Trainer(m.to(dtype), hp, device=dev)
            gen = torch.Generator().manual_seed(seed + 1)
            draws = {k: torch.randn(shape, generator=gen) for k, shape in tr.draw_shapes(batch).items()}
            loss, _, grads = tr.value_and_grad(batch, 0, draws)
            out[(label, dtype)] = (float(loss), {k: v.detach().cpu() for k, v in grads.items()})
    (l64, exact), (d64, g64) = out[("cpu", torch.float64)], out[("device", torch.float64)]
    (l32, c32), (d32, g32) = out[("cpu", torch.float32)], out[("device", torch.float32)]
    bad64, rows64 = hold_leaves(g64, exact, 1e-9)
    _, rows32 = hold_leaves(g32, exact, 1.0)
    _, rows32_cpu = hold_leaves(c32, exact, 1.0)
    numbers = {"leaves": len(exact), "loss_fp64": d64, "loss_fp64_cpu": l64, "loss_fp64_rel": abs(d64 / l64 - 1),
               "worst_leaf_fp64": rows64[0][1], "worst_rel_rms_fp64": rows64[0][0],
               "loss_fp32": d32, "loss_fp32_cpu": l32, "loss_fp32_rel": abs(d32 / l32 - 1),
               "fp32_vs_exact_worst_leaf": rows32[0][1], "fp32_vs_exact_worst_rel_rms": rows32[0][0],
               "fp32_vs_exact_worst_leaf_cpu": rows32_cpu[0][1], "fp32_vs_exact_worst_rel_rms_cpu": rows32_cpu[0][0]}
    failures = [f"fp64 leaf {n} {e:.2e} > {b:.0e}" for n, e, b in bad64]
    if not numbers["loss_fp64_rel"] <= 1e-12:
        failures.append(f"fp64 loss {d64!r} vs CPU {l64!r}")
    if not numbers["loss_fp32_rel"] <= 1e-5:
        failures.append(f"fp32 loss {d32!r} vs CPU {l32!r}")
    return failures, numbers


def gan_card_against_cpu(device, seed: int = 0) -> Tuple[List[str], Dict]:
    """One adversarial step (`TINY_WAVEGAN`) of the tiny case in fp64 on
    `device` against the CPU's, from one init and one set of draws: every
    metric within 1e-12 relative, every generator and discriminator gradient
    leaf within 1e-9 rel-RMS (`hold_leaves`).  Run it, as `card_against_cpu`,
    with MBEXWN_WN_DTYPE and MBEXWN_SUBNET_DTYPE set empty: the shipped bf16
    compute would otherwise apply.  Returns (failures, numbers)."""
    import copy

    from ..models import create_model
    from .adversarial import AdversarialTrainer

    hp = tiny_hparams()
    hp["wavegan_config"] = copy.deepcopy(TINY_WAVEGAN)
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"], trainable=True)
    model.init(torch.Generator().manual_seed(seed))
    state = {k: v.clone() for k, v in model.block.state_dict().items()}
    batch = tiny_batch()
    out = {}
    for label, dev in (("cpu", "cpu"), ("device", device)):
        m, _ = create_model(hp, hp["training_config"], hp["preprocess_config"], trainable=True)
        m.block.load_state_dict(state)
        tr = AdversarialTrainer(m.to(torch.float64), hp, device=dev, seed=seed)
        shapes = tr.base.draw_shapes(batch)
        gen = torch.Generator().manual_seed(seed + 1)
        draws = {k: torch.randn(shape, generator=gen) for k, shape in shapes.items()}
        disc_draws = {"noise": torch.randn(shapes["noise"], generator=gen),
                      "floor": torch.rand(shapes["floor"], generator=gen) * 2 - 1}
        metrics = {k: float(v) for k, v in tr.train_step(batch, draws, disc_draws).items()}
        grads = {f"generator.{k}": p.grad for k, p in tr.base.model.block.named_parameters()}
        grads.update({f"discriminator.{k}": p.grad for k, p in tr.discriminator.named_parameters()})
        out[label] = (metrics, {k: v.detach().cpu() for k, v in grads.items()})
    (ref_m, ref_g), (got_m, got_g) = out["cpu"], out["device"]
    bad, rows = hold_leaves(got_g, ref_g, 1e-9)
    worst_metric = max((abs(got_m[k] / ref_m[k] - 1) if ref_m[k] else abs(got_m[k]), k) for k in ref_m)
    numbers = {"leaves": len(rows), "metrics": got_m, "metrics_cpu": ref_m, "worst_metric": worst_metric[1],
               "worst_metric_rel": worst_metric[0], "worst_leaf": rows[0][1], "worst_leaf_rel_rms": rows[0][0]}
    failures = [f"leaf {n} {e:.2e} > {b:.0e}" for n, e, b in bad]
    if got_m.keys() != ref_m.keys() or not worst_metric[0] <= 1e-12:
        failures.append(f"metric {worst_metric[1]}: {got_m.get(worst_metric[1])!r} vs CPU {ref_m[worst_metric[1]]!r}")
    return failures, numbers
