"""PyTorch's intra-op threads in a process of the test suite.

The suite runs in several pytest-xdist workers at once, and by default
every PyTorch CPU op spreads over all of the machine's cores. Six workers
each starting as many threads as there are cores oversubscribe the
machine, and OpenMP's barriers then wait on threads that are not
running: 12 steps of the 320x160 shedding case took 232 s in a worker of
the suite's run, and 1.0 s once every worker had its share of the cores.
Importing this module gives the process its share of the cores (at least
one); a run in one process keeps them all. Results do not depend on it
beyond the order of float32 sums, which every tolerance already allows,
and two runs that a test compares bit for bit share the process's count.
"""

import os

import torch


def share_cores() -> int:
    """Set and return this process's intra-op threads: the cores it may
    run on over the number of pytest-xdist workers."""
    workers = max(1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()
    n = max(1, (cores or 1) // workers)
    if torch.get_num_threads() != n:
        torch.set_num_threads(n)
    return n


share_cores()
