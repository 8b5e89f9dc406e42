"""What the examples share: the ``--device`` flag and a one-rank process
group for ``ShardedEngine``."""
import argparse
import contextlib
import shutil
import tempfile

import torch
import torch.distributed as dist

from .._device import as_device


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with ``--device`` (default ``cuda``), parsed into
    a ``torch.device``: ``cuda`` without CUDA raises."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    type=lambda d: as_device(d, "example"),
                    help="torch device to run on (default: cuda; "
                         "'cpu' for the plain versions of the kernels)")
    return ap


@contextlib.contextmanager
def one_rank_group(device: torch.device):
    """A process group for a ``ShardedEngine``: the caller's when one is
    up, else a one-rank group of this process (NCCL for ``cuda``, gloo for
    ``cpu``, over a file store in a temporary directory), destroyed on
    exit."""
    if dist.is_initialized():
        yield
        return
    tmp = tempfile.mkdtemp(prefix="repro_torch_example_")
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"file://{tmp}/store", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
