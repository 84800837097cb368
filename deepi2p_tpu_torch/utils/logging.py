"""Metrics logging, the port's copy of the JAX package's
``utils/logging.py``: a JSONL stream of scalars (``metrics.jsonl`` in the
log directory) plus a TensorBoard event file when the ``tensorboard``
package imports (reference ``kitti/train_classifier.py:21-32``).

The event file is written with ``tensorboard``'s protos and record
framing only: ``torch.utils.tensorboard`` and ``tensorboard``'s own
``EventFileWriter`` import TensorFlow, and with it JAX, where they are
installed.  Each value of ``log_scalars(tag, values)`` is the scalar
``tag/name``.  ``log_image`` writes ``{tag}_{step}.png`` (``/`` in the tag
becomes ``_``) with the port's own PNG encoder, and the same PNG as an
image summary of the event file."""
from __future__ import annotations

import itertools
import json
import os
import socket
import time
from typing import Dict

import numpy as np

from .png import encode_png

_FILE_IDS = itertools.count()


class _EventFile:
    """``events.out.tfevents.*`` in ``log_dir``: one ``Event`` record per
    call, after the file-version record TensorBoard reads first."""

    def __init__(self, log_dir: str):
        from tensorboard.compat.proto.event_pb2 import Event
        from tensorboard.compat.proto.summary_pb2 import Summary
        from tensorboard.summary.writer.record_writer import RecordWriter
        self._event, self._summary = Event, Summary
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}.{next(_FILE_IDS)}")
        self._records = RecordWriter(open(os.path.join(log_dir, name), "xb"))
        self._write(Event(wall_time=time.time(), file_version="brain.Event:2"))

    def _write(self, event) -> None:
        self._records.write(event.SerializeToString())
        self._records.flush()

    def add_scalars(self, tag: str, values: Dict[str, float], step: int):
        S = self._summary
        self._write(self._event(
            wall_time=time.time(), step=step,
            summary=S(value=[S.Value(tag=f"{tag}/{k}", simple_value=v)
                             for k, v in values.items()])))

    def add_image(self, tag: str, png: bytes, height: int, width: int,
                  channels: int, step: int):
        S = self._summary
        image = S.Image(height=height, width=width, colorspace=channels,
                        encoded_image_string=png)
        self._write(self._event(wall_time=time.time(), step=step,
                                summary=S(value=[S.Value(tag=tag,
                                                         image=image)])))

    def close(self) -> None:
        self._records.close()


class MetricsLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            self._tb = _EventFile(log_dir)
        except ImportError:
            self._tb = None

    def log_scalars(self, tag: str, values: Dict[str, float], step: int):
        vals = {k: float(v) for k, v in values.items()}
        rec = {"tag": tag, "step": step, "time": time.time(), **vals}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalars(tag, vals, step)

    def log_image(self, tag: str, image, step: int):
        """image: (H, W, 3) RGB or (H, W) gray, uint8."""
        img = np.asarray(image)
        png = encode_png(img)
        path = os.path.join(self.log_dir,
                            f"{tag.replace('/', '_')}_{step}.png")
        with open(path, "wb") as f:
            f.write(png)
        if self._tb is not None:
            ch = img.shape[2] if img.ndim == 3 else 1
            self._tb.add_image(tag, png, img.shape[0], img.shape[1], ch,
                               step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
