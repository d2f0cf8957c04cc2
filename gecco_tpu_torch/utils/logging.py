"""Scalar/figure logging with a TensorBoard-or-JSONL backend (counterpart
of ``gecco_tpu/utils/logging.py``).

The writer surface is TensorBoard's (``add_scalar``, ``add_figure``,
``add_mesh``, ``add_image``): ``torch.utils.tensorboard``'s
``SummaryWriter`` where it imports (it needs the tensorboard package),
else a dependency-free JSONL writer.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

__all__ = ["make_writer", "JsonlWriter", "MockWriter"]


class JsonlWriter:
    """Append-only JSONL scalar log; figures/meshes are dropped with a note."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._path = os.path.join(logdir, "scalars.jsonl")
        self._file = open(self._path, "a")

    def add_scalar(self, tag: str, scalar_value=None, global_step: int = 0, **kw):
        record = {
            "tag": tag,
            "value": float(scalar_value),
            "step": int(global_step),
            "time": time.time(),
        }
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()

    def add_figure(self, tag: str, figure=None, global_step: int = 0, **kw):
        pass  # figures are tensorboard-only

    def add_mesh(self, tag: str, vertices=None, global_step: int = 0, **kw):
        pass

    def add_image(self, tag: str, img_tensor=None, global_step: int = 0, **kw):
        pass

    def close(self):
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MockWriter:
    """Shape-asserting writer used by the pre-training smoke test
    (training.py:88-97)."""

    def __getattr__(self, name):
        assert name.startswith("add_"), name

        def mock_add_fn(tag: str, *args, global_step: int, **kwargs):
            assert isinstance(tag, str)
            assert isinstance(global_step, int)
            assert len(args) + len(kwargs) >= 1

        return mock_add_fn

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


def make_writer(logdir: str) -> Any:
    """TensorBoard writer when available, JSONL otherwise."""
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(logdir)
    except Exception:
        return JsonlWriter(logdir)
