"""Child processes of the port's multi-process tests (tests/test_torch_*.py):
a module without JAX, so that a spawned child imports only torch and the
port."""
import os
import traceback


def multihost_child(rank: int, env: dict, results) -> None:
    """Join through `parallel.multihost.initialize()` from torchrun-style
    environment variables alone, sum the ranks with one all-reduce and put
    (rank, process_info, the sum) or (rank, the traceback)."""
    try:
        os.environ.update(env)
        import torch
        import torch.distributed as dist

        from mbexwn_vocoder_torch.parallel import multihost

        assert multihost.initialize()
        try:
            t = torch.tensor([float(rank + 1)])
            dist.all_reduce(t)
            results.put((rank, multihost.process_info(), float(t)))
        finally:
            multihost.shutdown()
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise
