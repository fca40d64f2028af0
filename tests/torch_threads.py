"""One intra-op thread for torch in each process that runs the port's
tests; every ``tests/test_torch_*.py`` imports this module first.

The suite runs under pytest-xdist, several worker processes on one
host.  With torch's default, one OpenMP thread per core in each worker,
the workers' thread teams overrun the cores and wait on each other: the
LM files of the port took 2.6x the summed time and 2.5x the wall of a
run with one thread a worker (``tests/junit_times.py`` on the two runs'
junit XML, ``-n 6 --dist loadfile``, 8 cores).  A test that pins its own
count (``torch.set_num_threads(2)`` for sums that repeat) restores this
one after it.  Subprocesses that the tests start take ``ONE_THREAD`` in
their environment.
"""
import torch

torch.set_num_threads(1)

ONE_THREAD = {"OMP_NUM_THREADS": "1"}
