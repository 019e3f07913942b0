"""Torch's CPU threads for the port's tests: the cores split among the
pytest-xdist workers.

Torch starts one intra-op thread a core in every process. Under
``pytest -n 6`` that is six workers of one thread a core each, and the
port's int64 threefry (``repro_torch.random``), a chain of ~200
elementwise ops over every draw, then spends its time switching threads:
on an 8-core machine a 131,072-element normal draw takes 2.4 s with 8
threads beside other workers and 0.05 s with one. So each worker takes
its share of the cores, and a run without xdist keeps them all.

A test module of the port imports this module for that effect. Every
xdist worker collects every module, so the first import sets the share
for the worker's whole run.
"""

import os

import torch


def share_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))


share_cores()
