"""The port's experiment harnesses (counterparts of the repo's
``experiments/fp8_study.py`` and ``experiments/scaling_harness.py``): each
runs its ranks as processes of one gloo group on the CPU, started by
``parallel/launch.py::run_ranks`` as a launcher would start them
(importable from here too)."""

from ..parallel.launch import run_ranks

__all__ = ["run_ranks"]
