"""Structured tracing hooks (reference: src/main.rs:25-32 + span sites).

The reference gates `tracing` spans behind a cargo feature with an
env-filtered subscriber. Here tracing is always compiled in and enabled at
runtime by the ``KRUST_LOG`` env var (e.g. ``KRUST_LOG=debug``), emitting via
the stdlib ``logging`` module. Every span is also a
``torch.profiler.record_function`` range of the same name, so phases
(``encode_count_batch``, ``epoch_flush``, ...) show up in profiler traces.

A span opened off the main thread (the feed's ``feed_pack`` and
``feed_stage`` on ``krust-feed``) reaches the collectors but, under a
default ``torch.profiler`` configuration, not the profiler's trace: only a
profiler set to profile every thread records it.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

logger = logging.getLogger("krust_tpu_torch")

_INITIALIZED = False

#: in-process trace subscribers: callables (kind, name, fields) where kind
#: is "span" (fields include elapsed_s) or "event". Harnesses install one to
#: attribute wall time per phase without parsing logs.
_COLLECTORS: list = []


def add_collector(fn) -> None:
    """Subscribe ``fn(kind, name, fields)`` to spans and events."""
    _COLLECTORS.append(fn)


def remove_collector(fn) -> None:
    try:
        _COLLECTORS.remove(fn)
    except ValueError:
        pass


def _emit(kind: str, name: str, fields: dict) -> None:
    for fn in list(_COLLECTORS):
        try:
            fn(kind, name, fields)
        except Exception:  # a broken subscriber must not break the engine
            logger.exception("trace collector failed")


def init_tracing(level: str | None = None) -> None:
    """Initialize the tracing subscriber from ``KRUST_LOG`` (or ``level``)."""
    global _INITIALIZED
    lvl_name = (level or os.environ.get("KRUST_LOG", "")).upper()
    if not lvl_name:
        return
    lvl = getattr(logging, lvl_name, None)
    if lvl is None:
        return
    if not _INITIALIZED:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
        logger.addHandler(handler)
        _INITIALIZED = True
    logger.setLevel(lvl)


@contextlib.contextmanager
def span(name: str, **fields):
    """A timed phase span (reference span names: read_sequences,
    process_sequences, unpack_kmers, ...). Also a profiler range.

    Yields its fields: a field known only inside the span is set there and
    reaches the collectors at its end."""
    start = time.perf_counter()
    logger.info("enter %s %s", name, fields if fields else "")
    try:
        with torch.profiler.record_function(name):
            yield fields
    finally:
        elapsed = time.perf_counter() - start
        logger.info("exit %s elapsed=%.6fs", name, elapsed)
        if _COLLECTORS:
            _emit("span", name, dict(fields, elapsed_s=elapsed))


def trace_event(message: str, **fields) -> None:
    """Emit a single structured event (reference: info!/debug! events)."""
    logger.info("%s %s", message, fields if fields else "")
    if _COLLECTORS:
        _emit("event", message, fields)
