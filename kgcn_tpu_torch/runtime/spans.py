"""Named ranges of the port's own phases in a ``torch.profiler`` trace.

``span(name)`` opens a ``record_function`` range named ``kgcn.<name>``.
Any profiler that records sees it: the CLI's ``profile`` trace
(``cli/main.py``) and a benchmark's traced slice alike, on the profiler's
host clock, which the device's records share; with no profiler recording
it is one no-op range.  Nothing is kept or exported here.

Spans sit at per-epoch phases only, never inside the per-step replay loop
or once a step:

* ``data.epoch_inputs``: the data layer's per-epoch host call
  (``Trainer.epoch_on_device``, ``eval_on_device``);
* ``train.table``, ``train.load`` / ``eval.load``, ``train.replay`` /
  ``eval.replay``, ``train.unload``: the whole-epoch runners' phases
  (``runtime/runner.py``), in that order: the optimizer's table computed
  on the host, the epoch's uploads, the step launches, the copy-out;
* ``train.read_back`` / ``eval.read_back``: the epoch's one
  synchronisation (``Trainer``);
* ``train.capture`` / ``eval.capture``: a runner's warm-up steps and its
  CUDA graph capture, once;
* ``ops.load``: a kernel library built or loaded (``ops/_build.py``).
"""
from __future__ import annotations

from torch.profiler import record_function

PREFIX = "kgcn."


def span(name: str) -> record_function:
    """A context manager: the range ``kgcn.<name>``."""
    return record_function(PREFIX + name)
