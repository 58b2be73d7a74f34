"""Benchmark of the PyTorch/CUDA port (``repro_torch``) of HeRo.

Driven by data: a cell is ``workloads/<cell>.json``, a model
configuration ``configs/<config>.json``, its model family
``families/<family>.py`` with the plain reference
``reference/<family>.py``, a kernel ``kernels/<label>.py``, a metric
``metrics/<metric>.py``; ``BENCHMARK.json`` at the repository root names
which metric each cell reports.  The yardstick (traffic, counts of
operations and bytes, rates and the union of intervals, the kernels'
symbols and costs, the plain reference and the comparison that decides
``correct``) lives here; the reference imports nothing of the program.
"""
