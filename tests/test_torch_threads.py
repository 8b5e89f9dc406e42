"""One intra-op thread for torch in every test process.

The suite runs under pytest-xdist with a worker for most cores.  Each
worker's torch would start an OpenMP pool of a thread a core, so the
workers would oversubscribe the cores several times over, and the port's
tests, most of them many small tensor ops, spend their time waiting on
each other's pools (a third of the port tests' time with six workers on
eight cores).  Every worker imports every test module when it collects
the suite, so setting the count in this module, at import, sets it for
every test the worker runs.  Run alone, a test file keeps torch's
default.
"""
import torch

torch.set_num_threads(1)


def test_torch_runs_one_intra_op_thread():
    assert torch.get_num_threads() == 1
