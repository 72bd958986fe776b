"""The port's parallel layer on the CPU: synthesis over a mesh of CPU
devices, the mesh helpers, joining a process group, and the kernels'
device context.

The model is tests/test_parallel.py's (SPEECH with a 16-channel, 3-layer
WaveNet, the noise channel off, no mel normalisation): JAX's init, folded,
is loaded into the port.  `BatchSynthesizer(mesh=)` splits a group into
shards whose rows are synthesised independently, so it equals `mesh=None`
to fp32 rounding (1e-6 rel-RMS; CPU shards give the same numbers), and it
is held against the JAX package's `BatchSynthesizer` over its virtual
8-device mesh at the whole-synthesis budget, 1e-3.  `synth_batched` over a
mesh likewise equals `mesh=None` (1e-6) and is held against the JAX
package's with a mesh at the bound tests/test_torch_streaming.py holds
`synth_batched` to (1e-3).
"""
import multiprocessing as mp
import queue
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import jax

from mbexwn_vocoder_tpu.ops.conv import fold_weight_norm as jax_fold
from mbexwn_vocoder_tpu.parallel import BatchSynthesizer as JaxBatchSynthesizer
from mbexwn_vocoder_tpu.parallel import StreamingSynthesizer as JaxStreamingSynthesizer
from mbexwn_vocoder_tpu.parallel import make_mesh as jax_make_mesh

from mbexwn_vocoder_torch import get_config_file
from mbexwn_vocoder_torch.compat.params_io import flatten, params_from_jax
from mbexwn_vocoder_torch.config import read_config
from mbexwn_vocoder_torch.models import create_model
from mbexwn_vocoder_torch.ops import oscillator as osc_mod
from mbexwn_vocoder_torch.ops import wavenet_stack as stack_mod
from mbexwn_vocoder_torch.parallel import BatchSynthesizer, StreamingSynthesizer
from mbexwn_vocoder_torch.parallel import multihost
from mbexwn_vocoder_torch.parallel.multihost import free_port
from mbexwn_vocoder_torch.parallel.mesh import make_mesh, shard_bounds

from tests.test_parallel import _small_model
from tests.test_torch_model import rel_rms
from tests.torch_mp_worker import multihost_child

torch.set_num_threads(2)
BUCKETS = (32, 64)
# tests/test_parallel.py::test_batch_synthesizer_dp's ten utterances
LENGTHS = (20, 35, 35, 50, 20, 28, 35, 50, 20, 31)


def _port_model(noise_sigma=0.0):
    hp = read_config(get_config_file("SPEECH"))
    mc = hp["mbexwn_config"]
    mc["pp_mod_subnet"].update(n_channels=16, n_layers=3, n_out_channels=8)
    mc["pp_mod_subnet_noise_channel_sigma"] = noise_sigma
    mc["normalize_rms_from_mell"] = False
    return create_model(hp, hp["training_config"], hp["preprocess_config"])[0]


@pytest.fixture(scope="module")
def models():
    jmodel, params = _small_model()
    model = _port_model()
    model.block.load_state_dict(params_from_jax(flatten(jax_fold(params))), strict=True)
    return jmodel, params, model.eval()


def _mells(lengths=LENGTHS, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(T, 80) * 0.5 - 4).astype(np.float32) for T in lengths]


def _cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


# ---- the mesh


def test_mesh_model_axis_is_not_ported():
    """The model axis is ported (tests/test_torch_tensor_parallel.py): a
    mesh is an n_data x n_model grid, row by row, as the JAX package's."""
    mesh = make_mesh(n_model=2, devices=["cpu"] * 4)
    assert mesh.shape == {"data": 2, "model": 2} and mesh.devices == (torch.device("cpu"),) * 2
    assert mesh.row(torch.device("cpu")) == (torch.device("cpu"),) * 2
    assert make_mesh(n_data=1, n_model=3, devices=["cpu"] * 4).shape == {"data": 1, "model": 3}


def test_mesh_defaults_to_every_card_and_never_to_the_cpu():
    mesh = make_mesh(devices=["cpu", "cpu", "cpu"])
    assert mesh.shape == {"data": 3, "model": 1} and mesh.axis_names == ("data", "model")
    assert make_mesh(n_data=2, devices=["cpu"] * 3).devices == (torch.device("cpu"),) * 2
    if torch.cuda.is_available():
        assert make_mesh().shape["data"] == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    assert shard_bounds(6, 3) == [(0, 2), (2, 4), (4, 6)]
    with pytest.raises(ValueError):
        shard_bounds(5, 2)


# ---- batch synthesis


@pytest.mark.parametrize("n_shards", [2, 3])
def test_batch_synthesizer_mesh_equals_no_mesh(models, n_shards):
    """Two shards, and three, which divide none of the buckets' groups of 5
    (each is padded to 6 and the padding dropped)."""
    _, _, model = models
    mells = _mells()
    got = BatchSynthesizer(model, mesh=_cpu_mesh(n_shards), length_buckets=BUCKETS).synth_batch(mells)
    ref = BatchSynthesizer(model, length_buckets=BUCKETS, device="cpu").synth_batch(mells)
    assert [y.shape for y in got] == [y.shape for y in ref] == [(T * 300,) for T in LENGTHS]
    for y, r in zip(got, ref):
        assert rel_rms(y, r) <= 1e-6


def test_batch_synthesizer_mesh_matches_jax_mesh(models):
    jmodel, params, model = models
    mells = _mells()
    jmesh = jax_make_mesh(n_data=8)
    with jmesh:
        ref = JaxBatchSynthesizer(jmodel, params, mesh=jmesh, length_buckets=BUCKETS).synth_batch(mells)
    got = BatchSynthesizer(model, mesh=_cpu_mesh(2), length_buckets=BUCKETS).synth_batch(mells)
    for y, r in zip(got, ref):
        assert y.shape == r.shape and rel_rms(y, r) <= 1e-3


def test_batch_synthesizer_mesh_gives_each_row_its_noise():
    """With the noise channel on, a row's noise is the one the same request
    draws without a mesh (row i of its run of 8), so the outputs agree to
    fp32 rounding: 19 utterances, one bucket holding runs of 8, 8 and 3."""
    model = _port_model(noise_sigma=0.5)
    model.init(torch.Generator().manual_seed(0))
    model.eval()
    mells = _mells(LENGTHS + (20, 21, 22, 23, 24, 25, 26, 27, 28), seed=3)
    ref = BatchSynthesizer(model, length_buckets=BUCKETS, device="cpu").synth_batch(mells)
    for n in (2, 3):
        got = BatchSynthesizer(model, mesh=_cpu_mesh(n), length_buckets=BUCKETS).synth_batch(mells)
        assert max(rel_rms(y, r) for y, r in zip(got, ref)) <= 1e-6


def test_replicas_are_one_per_distinct_device(models):
    _, _, model = models
    bs = BatchSynthesizer(model, mesh=make_mesh(devices=["cpu", "cpu"]))
    assert list(bs.replicas) == [torch.device("cpu")] and bs.model is model and bs.n_shards == 2


# ---- long form


def _long_mel(seed=5, frames=332):
    return (np.random.RandomState(seed).randn(1, frames, 80) * 0.5 - 4).astype(np.float32)


def test_synth_batched_mesh_equals_no_mesh(models, monkeypatch):
    """chunk 32, halo 16 over 332 frames: the 8 middle chunks are split over
    the mesh; the three edge chunks (groups of 1) stay on its first device."""
    _, _, model = models
    mell = _long_mel()
    ref = StreamingSynthesizer(model, chunk_frames=32, halo_frames=16, device="cpu").synth_batched(mell)
    ss = StreamingSynthesizer(model, chunk_frames=32, halo_frames=16, mesh=_cpu_mesh(2))
    rows = []
    infer = type(model).infer

    def recording(self, spect, *args, **kwargs):
        rows.append(spect.shape[0])
        return infer(self, spect, *args, **kwargs)

    monkeypatch.setattr(type(model), "infer", recording)
    got = ss.synth_batched(mell)
    assert got.shape == ref.shape == (1, 332 * 300)
    assert rel_rms(got, ref) <= 1e-6
    assert sorted(rows) == [1, 1, 1, 4, 4], rows


def test_synth_batched_mesh_matches_jax_mesh(models):
    jmodel, params, model = models
    mell = _long_mel()
    jmesh = jax_make_mesh(n_data=8)
    with jmesh:
        ref = JaxStreamingSynthesizer(jmodel, params, chunk_frames=32, halo_frames=16, mesh=jmesh).synth_batched(mell)
    got = StreamingSynthesizer(model, chunk_frames=32, halo_frames=16, mesh=_cpu_mesh(2)).synth_batched(mell)
    assert got.shape == ref.shape and rel_rms(got, ref) <= 1e-3


# ---- the kernels' device


def _recording_device(calls):
    def device(dev):
        calls.append(("enter", dev))

        @contextmanager
        def ctx():
            yield
            calls.append(("exit", dev))
        return ctx()
    return device


class _OnCard:
    """Stands in for a tensor on the second card: the kernel entries read
    its device before anything else."""
    device = torch.device("cuda", 1)


def test_kernel_callers_enter_the_tensors_device(monkeypatch):
    """Both kernel entries launch under the device of the tensors they are
    given, which need not be the current one: K1's shared-memory attribute
    and K2's occupancy count are the current device's."""
    calls = []
    monkeypatch.setattr(torch.cuda, "device", _recording_device(calls))

    def launch(name):
        def stub(*args, **kwargs):
            calls.append(("launch", name))
            return name
        return stub

    monkeypatch.setattr(stack_mod, "_wavenet_stack_cuda", launch("K1"))
    monkeypatch.setattr(osc_mod, "_oscillate_cuda", launch("K2"))
    x = _OnCard()
    # the CUDA implementations of the ops mbexwn::wavenet_stack and mbexwn::oscillate
    assert stack_mod._wavenet_stack_op_cuda(x, x, x, x, x, x, [], [], "gtu", False) == "K1"
    assert osc_mod._oscillate_op_cuda(x, x, 100.0, 2.0, 0.5, 2.0, 12000.0, None, False) == "K2"
    card = torch.device("cuda", 1)
    assert calls == [("enter", card), ("launch", "K1"), ("exit", card),
                     ("enter", card), ("launch", "K2"), ("exit", card)]


# ---- joining a process group


def test_initialize_without_a_world_joins_nothing(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.initialize() is False
    assert multihost.process_info()["world_size"] == 1


def test_two_processes_join_from_torchrun_variables(monkeypatch):
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = []
    for rank in range(2):
        env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORLD_SIZE": "2", "RANK": str(rank),
               "LOCAL_RANK": str(rank), "MBEXWN_PLATFORM": "cpu"}
        procs.append(ctx.Process(target=multihost_child, args=(rank, env, results)))
    for p in procs:
        p.start()
    try:
        got = {}
        for _ in range(2):
            try:
                rank, info, total = results.get(timeout=120)
            except queue.Empty:
                pytest.fail("a rank did not answer within 120 s")
            assert total is not None, info
            got[rank] = (info, total)
        for p in procs:
            p.join(timeout=60)
            assert not p.is_alive() and p.exitcode == 0
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    for rank, (info, total) in got.items():
        assert info == {"rank": rank, "world_size": 2, "local_rank": rank, "backend": "gloo",
                        "local_devices": info["local_devices"]}
        assert total == 3.0


def test_nccl_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the check is about hosts without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize("127.0.0.1:1", world_size=1, rank=0, device="cuda")
    with pytest.raises(RuntimeError, match="nccl backend needs a card"):
        multihost.initialize("127.0.0.1:1", world_size=1, rank=0, backend="nccl", device="cpu")

