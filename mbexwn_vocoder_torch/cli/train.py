"""CLI: train an MBExWN model on the card.

Counterpart of the JAX package's cli/train.py, with the same flags:

    python -m mbexwn_vocoder_torch.cli.train SPEECH -d wavs/ -o run/ [--steps N] [-b B]
        [--n_devices N] [--save_every N] [--log_every N] [--seed S] [--num_workers N] [--no_resume]
        [--init_from weights.npz [--init_step N]] [-a section:key=value ...]

It trains on the card; `MBEXWN_PLATFORM=cpu` trains on the CPU.

Data parallelism: `--n_devices N` (N > 1) spawns N processes, one per card
(cuda:0 .. cuda:N-1; N CPU processes over gloo with MBEXWN_PLATFORM=cpu),
joined in one process group; `--n_devices 0` spawns one per visible card,
also when there is only one.  The global batch (`-b`, which N must divide)
is split over the ranks, and every step equals the one-process step on the
global batch (training/trainer.py).  Under torchrun (`WORLD_SIZE` set) the
CLI joins the group torchrun made instead, whatever `--n_devices` says.
Rank 0 writes the checkpoints, the metrics and the export; every rank
resumes from the checkpoints; pretraining runs on rank 0 over the global
batch and its result is broadcast.  A rank that fails makes the CLI fail.
The run
directory gets the checkpoints (`checkpoints/<step>/`, the config's
checkpoint_dir), the metrics stream (`logs/metrics.jsonl`) and, at the
end, the model export that `MELInverter` loads: `weights.npz` (trainable
form, `v`/`g`), `config.yaml` and `weights.step`, the step the export was
taken at, written last.

Run order: resume from the newest checkpoint, else warm-start from
`--init_from` (fresh optimizer, its step counts moved to `--init_step`),
else a fresh init followed by activation pretraining when the config asks
for it; then the model summary, the data (seeded `seed + step`, so that a
resumed leg does not replay the segments of the last; the step's noise
draws seeded one higher), the loop, the last checkpoint and the export.
A replay of a target the run has reached is a no-op that builds no model:
when `--steps` is at most the newest checkpoint's step and the export's
recorded step equals that step.  With `--init_from` it is never taken; a
stale export (its step is not the newest checkpoint's) is made again.
"""
from __future__ import annotations

import gc
import os
import sys
import time
from typing import Dict, Optional

import numpy as np

EXPORT_STEP_FILE = "weights.step"
# a full collection every this many steps, as the JAX CLI's loop does
GC_EVERY = 200


def export_step(output_dir: str) -> Optional[int]:
    """The step of the run's export, or None when there is none."""
    try:
        with open(os.path.join(output_dir, EXPORT_STEP_FILE)) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def _write_atomic(path: str, write) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def _export(output_dir: str, model, hparams: Dict, step: int) -> None:
    from ..compat.params_io import params_to_jax

    write_export(output_dir, params_to_jax(model.block.state_dict()), hparams, step)


def write_export(output_dir: str, flat: Dict[str, np.ndarray], hparams: Dict, step: int) -> None:
    """The run's model export: `weights.npz` (the JAX-named parameters
    `flat`), `config.yaml` and, last, `weights.step`."""
    from ..compat.params_io import save_params
    from ..config import dump_config

    # np.savez appends ".npz" to a name without it
    tmp = os.path.join(output_dir, "weights.tmp.npz")
    save_params(tmp, flat)
    os.replace(tmp, os.path.join(output_dir, "weights.npz"))
    _write_atomic(os.path.join(output_dir, "config.yaml"), lambda p: dump_config(p, hparams))

    def write_step(p):
        with open(p, "w") as f:
            f.write(f"{step}\n")
    _write_atomic(os.path.join(output_dir, EXPORT_STEP_FILE), write_step)


def _warm_start(trainer, init_from: str, init_step: int) -> None:
    """The parameters of an inference weights.npz (trainable form) into the
    trainer's model; a fresh optimizer whose step counts are `init_step`."""
    from ..compat.params_io import flatten, load_params, params_from_jax, params_to_jax
    from ..training.trainer import fast_forward_opt_state

    flat = flatten(load_params(init_from))
    current = trainer.model.block.state_dict()
    if set(flat) != set(params_to_jax(current)):
        raise RuntimeError(f"--init_from {init_from}: parameter tree structure does not match this config's model")
    state = params_from_jax(flat)
    mismatch = [k for k, v in state.items() if tuple(v.shape) != tuple(current[k].shape)]
    if mismatch:
        raise RuntimeError(f"--init_from {init_from}: shape mismatch at {mismatch[:4]}")
    trainer.model.block.load_state_dict(state, strict=True)
    if init_step:
        # the schedule's position and Adam's bias correction on the original timeline
        fast_forward_opt_state(trainer, init_step)
    trainer.step = init_step


def _rss_gb() -> float:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9
    except (OSError, ValueError):
        return 0.0


def main(model_id, data_dir, output_dir, steps=10000, batch_size=None, n_devices=1, save_every=None, log_every=50,
         seed=42, cargs=None, resume=True, num_workers=2, init_from=None, init_step=0) -> Optional[Dict]:
    """Train as the module docstring says, on the device MBEXWN_PLATFORM
    names (the card unless it says cpu), over `n_devices` processes (1: this
    one; 0: one per visible card).  Returns the run's numbers (the device,
    the world size, time to the first step, host time per step, checkpoint
    saves, the loader's pace; rank 0's in a data-parallel run), or None for
    the no-op replay.  Without `resume` the checkpoint directory must hold
    no checkpoint: a second run's states beside the first's would make a
    later resume or replay take the wrong run."""
    from .. import get_config_file
    from ..config import modify_config, read_config
    from ..training.checkpointing import latest_step

    t_start = time.perf_counter()
    hparams = read_config(get_config_file(model_id))
    if cargs:
        modify_config(hparams, cargs)
    tc, cc = hparams["training_config"], hparams["checkpoint_config"]
    batch_size = batch_size or tc["train_batch_size"]
    checkpoint_dir = os.path.join(output_dir, cc.get("checkpoint_dir", "checkpoints"))
    done = latest_step(checkpoint_dir)
    if not resume and done is not None:
        raise FileExistsError(f"--no_resume: {checkpoint_dir} holds checkpoints of an earlier run (newest step "
                              f"{done}); remove them or train into another output directory")
    if (resume and not init_from and done is not None and done >= steps and export_step(output_dir) == done
            and os.path.exists(os.path.join(output_dir, "weights.npz"))
            and os.path.exists(os.path.join(output_dir, "config.yaml"))):
        print(f"checkpoint already at step {done} >= target {steps} and exported at it; nothing to train",
              file=sys.stderr)
        print(f"exported inference model to {output_dir}", file=sys.stderr)
        return None

    kwargs = dict(model_id=model_id, data_dir=data_dir, output_dir=output_dir, steps=steps, batch_size=batch_size,
                  save_every=save_every, log_every=log_every, seed=seed, cargs=cargs, resume=resume,
                  num_workers=num_workers, init_from=init_from, init_step=init_step, t_start=t_start)
    if os.environ.get("WORLD_SIZE"):  # under torchrun: join its group
        from ..parallel import multihost

        _check_divisible(batch_size, int(os.environ["WORLD_SIZE"]))
        multihost.initialize()
        try:
            return _train(hparams, distributed=True, **kwargs)
        finally:
            multihost.shutdown()
    if n_devices == 1:
        return _train(hparams, distributed=False, **kwargs)
    return _spawn(n_devices, batch_size, kwargs)


def _check_divisible(batch_size: int, n: int) -> None:
    if batch_size % n:
        raise RuntimeError(f"batch_size {batch_size} must be divisible by n_devices {n}")


def _spawn(n_devices: int, batch_size: int, kwargs: Dict) -> Dict:
    """Train over `n_devices` spawned processes (0: one per visible card);
    rank 0's numbers.  A rank that exits non-zero stops the others and
    raises; each rank fails by itself when the group does not form or a
    collective hangs (`parallel.multihost.TIMEOUT`), so a hung start ends
    here as a failure."""
    import multiprocessing as mp
    import queue

    from ..platform import platform_device
    from ..parallel.multihost import free_port

    dev = platform_device()
    if n_devices == 0:
        if dev.type != "cuda":
            raise ValueError("--n_devices 0 counts the visible cards; on the CPU give the number of processes")
        import torch

        n_devices = torch.cuda.device_count()
    if n_devices < 1:
        raise ValueError(f"--n_devices {n_devices}: expected a count >= 1 (or 0 for every visible card)")
    _check_divisible(batch_size, n_devices)
    if dev.type == "cuda":
        import torch

        if n_devices > torch.cuda.device_count():
            raise ValueError(f"--n_devices {n_devices}: only {torch.cuda.device_count()} cards are visible")
        from ..ops import kernel_lib

        kernel_lib.build()  # once here, so that no rank that synthesises runs nvcc
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    master = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main, args=(rank, n_devices, master, dev.type, kwargs, results))
             for rank in range(n_devices)]
    for p in procs:
        p.start()
    run = None
    try:
        while True:
            try:
                rank, out = results.get(timeout=0.5)
                if rank == 0:
                    run = out
            except queue.Empty:
                pass
            codes = [p.exitcode for p in procs]
            failed = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                raise RuntimeError(f"data-parallel training failed: rank(s) {failed} exited non-zero")
            if all(c == 0 for c in codes) and results.empty():
                break
    finally:
        for p in procs:
            p.join(timeout=30)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return run


def _rank_main(rank: int, world: int, master: str, device_type: str, kwargs: Dict, results) -> None:
    """One spawned rank: join the group, train, hand rank 0's numbers back."""
    from .. import get_config_file
    from ..config import modify_config, read_config
    from ..parallel import multihost

    hparams = read_config(get_config_file(kwargs["model_id"]))
    if kwargs["cargs"]:
        modify_config(hparams, kwargs["cargs"])
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the ranks share the host's cores
    os.environ["LOCAL_RANK"] = str(rank)
    multihost.initialize(master, world_size=world, rank=rank,
                         device=f"cuda:{rank}" if device_type == "cuda" else "cpu")
    try:
        results.put((rank, _train(hparams, distributed=True, **kwargs)))
    finally:
        multihost.shutdown()


def _train(hparams: Dict, model_id, data_dir, output_dir, steps, batch_size, save_every, log_every, seed, cargs,
           resume, num_workers, init_from, init_step, t_start, distributed: bool) -> Dict:
    """The run itself, in this process; with `distributed`, as one rank of
    the process group this process has joined."""
    import torch

    from ..models.factory import create_model
    from ..observability import MetricsLogger, model_summary
    from ..platform import platform_device
    from ..training.checkpointing import CheckpointManager
    from ..training.data import PrefetchLoader, SegmentDataset
    from ..training.trainer import Trainer

    group, rank, world = None, 0, 1
    dev = platform_device()
    if distributed:
        import torch.distributed as dist

        group, rank, world = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())

    def say(msg: str) -> None:
        if rank == 0:
            print(msg, file=sys.stderr)

    tc, pc, cc = hparams["training_config"], hparams["preprocess_config"], hparams["checkpoint_config"]
    checkpoint_dir = os.path.join(output_dir, cc.get("checkpoint_dir", "checkpoints"))
    save_every = save_every or cc.get("save_model_every", 2000)
    os.makedirs(output_dir, exist_ok=True)

    model, _ = create_model(hparams, tc, pc, quiet=True, trainable=True)
    model.init(torch.Generator().manual_seed(seed))
    T_mel = pc["segment_length"] // pc["hop_size"] + 1
    ckpt = CheckpointManager(checkpoint_dir, max_to_keep=cc.get("max_to_keep", 5), group=group)
    latest = ckpt.latest_step() if resume else None
    start = latest if latest is not None else (init_step if init_from else 0)
    data_seed = seed + start
    trainer = Trainer(model, hparams, device=dev, seed=data_seed + 1, group=group)
    run = {"device": str(dev), "world_size": world, "start_step": start, "resumed": latest is not None,
           "warm_started": latest is None and bool(init_from), "pretrained": False}
    if latest is not None:
        ckpt.restore(trainer)
        say(f"resumed from step {trainer.step}")
    elif init_from:
        _warm_start(trainer, init_from, init_step)
        say(f"warm-started from {init_from} at step {init_step}")
    elif tc.get("pretrain_activations_target"):
        if rank == 0:  # on the global batch, as one process would
            from ..training.pretrain import pretrain_activations

            dataset0 = SegmentDataset(data_dir, pc, seed=seed)
            try:
                cal_mels = [dataset0.batch(batch_size)["mel"] for _ in range(2)]
            finally:
                dataset0.close()
            say("pretraining activation statistics...")
            ploss = pretrain_activations(model, cal_mels, target=tc["pretrain_activations_target"],
                                         max_iters=tc.get("pretrain_activations_max_iters", 100),
                                         lr=tc.get("pretrain_activations_lr", 1e-2),
                                         to_rmse=tc.get("pretrain_activations_to_rmse", 0.05))
            say(f"pretraining done (stats loss {ploss:.4f})")
        trainer.broadcast(model)
        run["pretrained"] = True

    if rank == 0:
        model_summary(model, T_mel=T_mel, print_fn=lambda s: print(s, file=sys.stderr))

    dataset = SegmentDataset(data_dir, pc, seed=data_seed, shard=(rank, world))
    loader = PrefetchLoader(dataset, batch_size, num_workers=num_workers)
    logger = MetricsLogger(os.path.join(output_dir, cc.get("log_dir", "logs"))) if rank == 0 else None
    # the F0 target pre-strided to the pulse rate (the values the training
    # forward keeps) and, unless MBEXWN_UPLOAD_FP16=0, audio and mel as fp16
    # (made fp32 on the device): the JAX package's uploads, so both feed the
    # step the same numbers
    upload_fp16 = os.environ.get("MBEXWN_UPLOAD_FP16", "1") != "0"
    if upload_fp16:
        say("upload: audio/mel as fp16 (MBEXWN_UPLOAD_FP16=0 for fp32 uploads)")
    f0_down = trainer.F0_down
    pinned = dev.type == "cuda"

    def _prep(b):
        out = {}
        for k, v in b.items():
            if k == "F0":
                k, v = "F0_ds", v[:, ::f0_down]
            elif upload_fp16 and k in ("audio", "mel"):
                v = v.astype(np.float16)
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.pin_memory().to(dev, non_blocking=True) if pinned else t
        return out

    run["step_host_s"], run["checkpoints"] = {}, []

    def save(step):
        t0 = time.perf_counter()
        if ckpt.save(step, trainer):
            run["checkpoints"].append({"step": step, "ms": 1e3 * (time.perf_counter() - t0),
                                       "bytes": os.path.getsize(ckpt.path(step))})

    t_last = time.time()
    batches = iter(loader)
    try:
        while trainer.step < steps:
            t0 = time.perf_counter()
            metrics = trainer.train_step(_prep(next(batches)))
            step = trainer.step
            if rank == 0 and (step % log_every == 0 or step == 1):
                m = {k: float(v) for k, v in metrics.items()}
                logger.log(step, m)
                dt = time.time() - t_last
                t_last = time.time()
                loss_str = " ".join(f"{k}:{v:7.4f}" for k, v in sorted(m.items()))
                say(f"step {step:7d} ({dt:5.1f}s/{log_every}) rss={_rss_gb():.1f}G {loss_str}")
            t1 = time.perf_counter()
            run["step_host_s"][step] = t1 - t0
            run.setdefault("time_to_first_step_s", t1 - t_start)
            if step % GC_EVERY == 0:
                gc.collect()
            if step % save_every == 0:
                save(step)
    finally:
        if loader.close():
            dataset.close()
        if logger is not None:
            logger.close()
    run["loader"] = dict(loader.stats(), source=dataset.source)

    save(trainer.step)
    if rank == 0:
        _export(output_dir, model, hparams, trainer.step)
    run["end_step"] = trainer.step
    say(f"exported inference model to {output_dir}")
    return run


def cli():
    from argparse import ArgumentParser

    parser = ArgumentParser(description="train an MBExWN vocoder model")
    parser.add_argument("model_id", help="model id or model directory (config source)")
    parser.add_argument("-d", "--data_dir", required=True, help="directory with training wavs")
    parser.add_argument("-o", "--output_dir", required=True)
    parser.add_argument("--steps", type=int, default=10000)
    parser.add_argument("-b", "--batch_size", type=int, default=None)
    parser.add_argument("--n_devices", type=int, default=1,
                        help="data-parallel processes, one per card (0 = every visible card); "
                             "not read under torchrun")
    parser.add_argument("--save_every", type=int, default=None)
    parser.add_argument("--log_every", type=int, default=50)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--num_workers", type=int, default=2,
                        help="prefetch threads extracting mel/F0 targets")
    parser.add_argument("--no_resume", dest="resume", action="store_false")
    parser.add_argument("--init_from", default=None,
                        help="warm-start params from an inference weights.npz "
                             "(used only when no checkpoint restores)")
    parser.add_argument("--init_step", type=int, default=0,
                        help="step counter to start from with --init_from")
    parser.add_argument("-a", "--cargs", default=None, nargs="+",
                        help="config overrides with ':' as field separator")
    args = parser.parse_args()
    main(**vars(args))


if __name__ == "__main__":
    cli()
