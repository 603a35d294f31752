"""Telemetry: metric pytrees → single host transfer per tick + structured logs.

The reference's only runtime data-out channel is packing mixed scalars/vectors
into one ``yarp::sig::Vector`` and publishing it on a buffered port
(``mergeSigVector``/``sendVariadicVector``, ``YarpUtilities/Helper.tpp:179-237``;
SURVEY.md §5 "metrics/logging"). The accelerator-native mapping (SURVEY.md §7): flatten
a pytree of device metrics into ONE array, move it device→host once per tick,
and fan it back out to named channels on the host — minimizing transfers the
way the reference's single-port packing minimized YARP messages.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any, Dict, Iterator, List, Optional

import jax
import numpy as np

from blf_tpu.utils.containers import tree_concat

__all__ = ["merge_metrics", "TelemetryStream", "get_logger"]

_LOGGER_NAME = "blf_tpu"


def get_logger(name: str = _LOGGER_NAME) -> logging.Logger:
    """Structured logger replacing the reference's tagged ``std::cerr``
    protocol (``[Class::method] message``, e.g.
    ``LinearTimeInvariantSystem.cpp:44-48``)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("[%(name)s.%(levelname)s] %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger


def merge_metrics(metrics: Dict[str, Any]):
    """Flatten a dict of device scalars/arrays into one 1-D device array plus
    a layout for host-side unpacking — ``mergeSigVector``
    (``Helper.tpp:179-200``) for pytrees."""
    layout = [(name, tuple(np.shape(value))) for name, value in metrics.items()]
    merged = tree_concat([jax.numpy.asarray(v) for v in metrics.values()])
    return merged, layout


class TelemetryStream:
    """Per-tick telemetry channel: one device→host transfer, named fan-out.

    Equivalent of a YARP buffered port carrying the merged vector
    (``sendVariadicVector``, ``Helper.tpp:228-237``); sinks are JSONL
    streams/files instead of ports.
    """

    def __init__(self, sink=None, name: str = "telemetry"):
        self._sink = sink if sink is not None else sys.stdout
        self._name = name
        self._history: List[Dict[str, Any]] = []

    def publish(self, metrics: Dict[str, Any], step: Optional[int] = None) -> Dict[str, Any]:
        """Merge → single transfer → unpack → emit one JSONL record."""
        merged, layout = merge_metrics(metrics)
        host = np.asarray(merged)          # the one device→host transfer
        record: Dict[str, Any] = {
            "stream": self._name,
            "time": time.time(),
        }
        if step is not None:
            record["step"] = step
        k = 0
        for name, shape in layout:
            size = int(np.prod(shape)) if shape else 1
            chunk = host[k : k + size]
            record[name] = (
                float(chunk[0]) if not shape else chunk.reshape(shape).tolist()
            )
            k += size
        self._history.append(record)
        print(json.dumps(record), file=self._sink)
        return record

    @property
    def history(self) -> List[Dict[str, Any]]:
        return self._history
