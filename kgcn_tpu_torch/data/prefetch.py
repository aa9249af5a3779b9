"""Threaded batch prefetching — the counterpart of ``kgcn_tpu/data/prefetch.py``.

Host batch assembly (the NumPy packing, the tiled and stream structures'
C++ builders) runs in a background thread while the card runs the current
step: a double-buffered input pipeline.  The consumer moves each batch to
the card on its own thread (``Trainer.train_step`` does).  The queue is
bounded, an error in the producer is raised in the consumer, and a
consumer that abandons the generator releases and joins the producer.

``KGCN_PREFETCH=0`` (or ``false``/``off``) turns it off.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def _enabled() -> bool:
    env = os.environ.get("KGCN_PREFETCH")
    return env is None or env not in ("0", "false", "off")


def prefetch(iterable: Iterable[T], size: int = 2) -> Iterator[T]:
    """Wrap an iterator so ``size`` items are prepared ahead in a thread."""
    if not _enabled():
        yield from iterable
        return
    q: "queue.Queue" = queue.Queue(maxsize=size)
    err: list = []
    stop = threading.Event()

    def _put(item) -> bool:
        # a bounded put that gives up once the consumer has left: a plain
        # q.put would block this thread forever
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterable:
                if not _put(item):
                    return
        except BaseException as e:  # raised again in the consumer
            err.append(e)
        finally:
            _put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        # the consumer left (done, an exception, or the generator collected):
        # release the producer, join it, then drain (a producer blocked in
        # _put can complete its put after stop is set)
        stop.set()
        t.join(timeout=5.0)
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
