"""The tiny training case that the parity checks share, and their per-leaf
gradient rule.

The case is SPEECH with a 16-channel, 2-layer WaveNet, F0 loss, teacher
forcing 0.5 and STFT coherence 0.1, T_mel = 8, batch 2.  The CPU tests hold
the port's loss and gradients on it against the JAX package's; the card
test and `chip_smoke.py` phase [9](b) hold the card's against the CPU's,
and phase [10](c) does the same for one adversarial step (`TINY_WAVEGAN`,
a small discriminator).

The data-parallel check (`dp_against_single`, the CPU tests and
`chip_smoke.py` phase [11](a)) runs the tiny case at a global batch of 4
(`tiny_dp_batch`: the two shards' voiced-frame counts differ) in fp64 on
`world` processes joined over gloo, and holds one step of the `Trainer`
and one of the `AdversarialTrainer` against the one-process step on the
same global batch, draws and init: the loss and every metric within
1e-12, every gradient leaf and updated parameter within 1e-9.  The same
step with DDP's rule, each rank's loss the mean over its own shard and the
gradients averaged, is reported beside it, to show that the check can see
the coupling of the batch's samples.

Gradients are compared leaf by leaf as rel-RMS (`hold_leaves`); a leaf
whose norm is under 1e-6 of the largest is held to 1e-7 absolute instead.
The tight comparisons are made in fp64.  In fp32 the gradient of this loss
on a randomly initialised model is only determined to 1e-3 - 1e-2 rel-RMS,
depending on the init, on the CPU as on the card and in the JAX package:
the log-spectral L1 loss and the F0 gradient through the oscillator's
table lookup both turn fp32 rounding into errors of that size.
"""
from __future__ import annotations

import os
import traceback
from typing import Callable, Dict, List, Optional, Tuple, Union

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


def tiny_dp_batch(seed: int = 2, batch: int = 4) -> Dict[str, np.ndarray]:
    """`tiny_batch` at a global batch of `batch`, whose first half is mostly
    unvoiced and second half mostly voiced: the shards of two ranks hold
    different numbers of voiced frames, which the F0 loss's weights count."""
    rng = np.random.RandomState(seed)
    T = TINY_T_MEL * TINY_HOP
    f0 = (120 + 10 * rng.randn(batch, T)).astype(np.float32)
    for r in range(batch):
        lo = 200 + 150 * r
        f0[r, lo: lo + (1800 if r < batch // 2 else 300)] = 0.0
    return {"audio": (rng.randn(batch, T) * 0.1).astype(np.float32),
            "mel": (rng.randn(batch, TINY_T_MEL, 80) * 0.5 - 4).astype(np.float32), "F0": f0}


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


def card_against_cpu(device, seed: int = 0, edits: Optional[Dict] = None) -> Tuple[List[str], Dict]:
    """The tiny case's loss and gradients on `device` against the CPU's,
    from one init (the port's, seeded) and one set of draws: in fp64 the
    loss within 1e-12 relative and every leaf within 1e-9 rel-RMS; in fp32
    the loss within 1e-5.  The fp32 gradients of both devices are reported
    against the CPU's fp64 ones (module docstring).  `edits` are
    `tiny_hparams`' overrides.  Returns (failures, numbers; "metrics" the
    device's fp64 loss terms)."""
    from ..models import create_model
    from .trainer import Trainer

    hp = tiny_hparams(**(edits or {}))
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
            loss, metrics, grads = tr.value_and_grad(batch, 0, draws)
            out[(label, dtype)] = (float(loss), {k: v.detach().cpu() for k, v in grads.items()})
    metrics = {k: float(v) for k, v in metrics.items()}
    (l64, exact), (d64, g64) = out[("cpu", torch.float64)], out[("device", torch.float64)]
    (l32, c32), (d32, g32) = out[("cpu", torch.float32)], out[("device", torch.float32)]
    bad64, rows64 = hold_leaves(g64, exact, 1e-9)
    _, rows32 = hold_leaves(g32, exact, 1.0)
    _, rows32_cpu = hold_leaves(c32, exact, 1.0)
    numbers = {"leaves": len(exact), "loss_fp64": d64, "loss_fp64_cpu": l64, "loss_fp64_rel": abs(d64 / l64 - 1),
               "worst_leaf_fp64": rows64[0][1], "worst_rel_rms_fp64": rows64[0][0],
               "loss_fp32": d32, "loss_fp32_cpu": l32, "loss_fp32_rel": abs(d32 / l32 - 1),
               "fp32_vs_exact_worst_leaf": rows32[0][1], "fp32_vs_exact_worst_rel_rms": rows32[0][0],
               "fp32_vs_exact_worst_leaf_cpu": rows32_cpu[0][1], "fp32_vs_exact_worst_rel_rms_cpu": rows32_cpu[0][0],
               "metrics": metrics}
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


# ------------------------------------------------------------- data parallel


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().double().numpy()


def dp_step(case: Dict, device, group=None, naive: bool = False) -> Dict:
    """One `Trainer` step, and one `AdversarialTrainer` step when `case`
    has "wavegan", of `case` on `device`: on this rank's rows of the global
    batch under `group`, else on the whole batch.  `naive` replaces the
    exact global-batch loss with DDP's rule (the rank's own loss, the
    gradients averaged).  `case`: "hp", "state" (the model's trainable
    state, numpy), "dtype", "batch" and "draws" (global, numpy), and
    "disc_draws" with "wavegan".  Returns numpy results: loss, metrics,
    gradients, parameters after the step, and the GAN step's."""
    import copy

    import torch.distributed as dist

    from ..models import create_model
    from .adversarial import AdversarialTrainer
    from .trainer import Trainer

    dtype = getattr(torch, case["dtype"])
    world = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    n = next(iter(case["batch"].values())).shape[0] // world
    batch = {k: v[rank * n: (rank + 1) * n] for k, v in case["batch"].items()}

    def model():
        m, _ = create_model(case["hp"], case["hp"]["training_config"], case["hp"]["preprocess_config"],
                            trainable=True)
        m.block.load_state_dict({k: torch.from_numpy(v) for k, v in case["state"].items()}, strict=True)
        return m.to(dtype)

    def make_naive(tr):
        def globalise(means, sums):
            return means, sums

        def sync_gradients(params):
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            for p in params:
                dist.all_reduce(p.grad, group=group)
                p.grad /= world
        tr.globalise, tr.sync_gradients = globalise, sync_gradients

    tr = Trainer(model(), case["hp"], device=device, group=group)
    if naive and group is not None:
        make_naive(tr)
    loss, metrics, grads = tr.value_and_grad(batch, 0, case["draws"])
    out = {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
           "grads": {k: _host(v) for k, v in grads.items()}}
    tr.apply_gradients()
    out["params"] = {k: _host(v) for k, v in tr.model.block.named_parameters()}
    if "wavegan" in case:
        hp = copy.deepcopy(case["hp"])
        hp["wavegan_config"] = copy.deepcopy(case["wavegan"])
        gan = AdversarialTrainer(model(), hp, device=device, group=group)
        if naive and group is not None:
            make_naive(gan.base)
        m = gan.train_step(batch, case["draws"], case["disc_draws"])
        out["gan_metrics"] = {k: float(v) for k, v in m.items()}
        grads = {f"generator.{k}": p.grad for k, p in gan.base.model.block.named_parameters()}
        grads.update({f"discriminator.{k}": p.grad for k, p in gan.discriminator.named_parameters()})
        out["gan_grads"] = {k: _host(v) for k, v in grads.items()}
        out["gan_params"] = {f"generator.{k}": _host(v) for k, v in gan.base.model.block.named_parameters()}
        out["gan_params"].update({f"discriminator.{k}": _host(v) for k, v in gan.discriminator.named_parameters()})
    return out


def _dp_rank(rank: int, world: int, init_method: str, device: str, case: Dict, results) -> None:
    """One rank of `run_dp` (a spawned process): join over gloo, take the
    exact step and (unless `case["naive"]` is false) the naive one, put
    (rank, results or the traceback)."""
    import torch.distributed as dist

    try:
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // (2 * world)))  # the ranks share the host
        dist.init_process_group("gloo", init_method=init_method, world_size=world, rank=rank)
        try:
            out = {"exact": dp_step(case, device, dist.group.WORLD)}
            if case.get("naive", True):
                out["naive"] = dp_step(case, device, dist.group.WORLD, naive=True)
            results.put((rank, out))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise


def run_dp(case: Dict, device, world: int = 2, timeout: float = 600.0) -> List[Dict]:
    """`dp_step` of `case` on `world` spawned processes joined over gloo
    (all on `device`: gloo takes CPU and card tensors, and lets ranks share
    a card, which NCCL refuses): each rank's {"exact", "naive"} results, by
    rank ("naive" unless `case["naive"]` is false).  A rank that fails, or does not answer within `timeout` seconds,
    raises here; every process is gone when this returns."""
    import multiprocessing as mp
    import queue

    from ..parallel.multihost import free_port

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_dp_rank, args=(r, world, init_method, str(device), case, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got: Dict[int, Dict] = {}
    try:
        for _ in range(world):
            try:
                rank, out = results.get(timeout=timeout)
            except queue.Empty:
                raise RuntimeError(f"a data-parallel rank did not answer within {timeout:.0f} s") from None
            if isinstance(out, str):
                raise RuntimeError(f"data-parallel rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=60)
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise RuntimeError(f"data-parallel ranks exited with {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]


def tiny_dp_case(seed: int = 0, batch: int = 4) -> Dict:
    """The tiny case in fp64 at a global batch of `batch` (`tiny_dp_batch`),
    with its draws, the GAN's (`TINY_WAVEGAN`) included."""
    import copy

    from ..models import create_model
    from .trainer import Trainer

    hp = tiny_hparams()
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"], trainable=True)
    model.init(torch.Generator().manual_seed(seed))
    glob = tiny_dp_batch(batch=batch)
    shapes = Trainer(model, hp, device="cpu").draw_shapes(glob)
    gen = torch.Generator().manual_seed(seed + 1)
    draws = {k: torch.randn(shape, generator=gen).numpy() for k, shape in shapes.items()}
    disc_draws = {"noise": torch.randn(shapes["noise"], generator=gen).numpy(),
                  "floor": (torch.rand(shapes["floor"], generator=gen) * 2 - 1).numpy()}
    return {"hp": hp, "state": {k: v.detach().numpy().copy() for k, v in model.block.state_dict().items()},
            "dtype": "float64", "batch": glob, "draws": draws, "disc_draws": disc_draws,
            "wavegan": copy.deepcopy(TINY_WAVEGAN)}


def _worst(got: Dict[str, float], ref: Dict[str, float]) -> Tuple[float, str]:
    return max((abs(got[k] / ref[k] - 1) if ref[k] else abs(got[k]), k) for k in ref)


def dp_against_single(device, world: int = 2, seed: int = 0, naive: bool = True) -> Tuple[List[str], Dict]:
    """`tiny_dp_case` on `world` gloo ranks against the one-process step
    (module docstring); with `naive`, DDP's rule beside it, which must be
    off by more than 1e-6.  Run it with MBEXWN_WN_DTYPE and
    MBEXWN_SUBNET_DTYPE set empty, as `card_against_cpu`.  Returns
    (failures, numbers)."""
    case = dict(tiny_dp_case(seed), naive=naive)
    ref = dp_step(case, device)
    ranks = run_dp(case, device, world)
    f0 = case["batch"]["F0"]
    n = f0.shape[0] // world
    numbers = {"world": world, "global_batch": f0.shape[0],
               "voiced_samples_per_shard": [int((f0[r * n: (r + 1) * n] != 0).sum()) for r in range(world)]}
    failures = []
    for what, metric_key, leaf_keys in (("step", "metrics", ("grads", "params")),
                                        ("GAN step", "gan_metrics", ("gan_grads", "gan_params"))):
        for rank, out in enumerate(ranks):
            exact = out["exact"]
            rel, name = _worst(exact[metric_key], ref[metric_key])
            rows = []
            for key in leaf_keys:
                bad, r = hold_leaves(exact[key], ref[key], 1e-9)
                rows += r
                failures += [f"{what} rank {rank} {key} {n} {e:.2e} > {b:.0e}" for n, e, b in bad]
            if not rel <= 1e-12 or exact[metric_key].keys() != ref[metric_key].keys():
                failures.append(f"{what} rank {rank} metric {name} {exact[metric_key].get(name)!r} vs "
                                f"{ref[metric_key][name]!r}")
            if rank == 0:
                worst = max(rows)
                numbers[what] = {"worst_metric": name, "worst_metric_rel": rel, "worst_leaf": worst[1],
                                 "worst_leaf_rel_rms": worst[0], "leaves": len(rows)}
            if rank == 0 and naive:
                naive_metrics = {k: float(np.mean([o["naive"][metric_key][k] for o in ranks]))
                                 for k in ref[metric_key]}
                naive_rel, naive_name = _worst(naive_metrics, ref[metric_key])
                _, naive_rows = hold_leaves(out["naive"][leaf_keys[0]], ref[leaf_keys[0]], 1.0)
                numbers[what].update(naive_worst_metric=naive_name, naive_worst_metric_rel=naive_rel,
                                     naive_worst_gradient_leaf=naive_rows[0][1],
                                     naive_worst_gradient_rel_rms=naive_rows[0][0])
                if not max(naive_rel, naive_rows[0][0]) > 1e-6:
                    failures.append(f"{what}: the naive per-rank mean is within 1e-6 of the global step "
                                    f"({naive_rel:.2e}, {naive_rows[0][0]:.2e}): the check cannot see the coupling")
    return failures, numbers
