"""Shape cells: the (kind, sequence length, global batch) a step is built for.

The port of ``repro/configs/base.py``.  Every architecture module exposes
``config()`` (the published dims), ``reduced()`` (a same-family miniature for CPU
tests) and ``SUBQUADRATIC``, whether the arch can run the ``long_500k`` cell."""

from __future__ import annotations

import dataclasses
from typing import Literal

Kind = Literal["train", "prefill", "decode"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: Kind
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}
