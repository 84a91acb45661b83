"""Metric logging (the port's own copy of what the training loop needs from
``da_detect_tpu/utils/metric_logger.py``): windowed median and global mean
of each meter, the ETA string, ``Timer``, and ``TensorboardLogger`` (the
CLIs' ``--use-tensorboard``), which also writes each update as TensorBoard
scalars through ``torch.utils.tensorboard``."""

from __future__ import annotations

import datetime
import logging
import time
from collections import defaultdict, deque

log = logging.getLogger(__name__)


class SmoothedValue:
    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        self.deque.append(value)
        self.count += 1
        self.total += value

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, iteration: int | None = None, **kwargs):
        """One value a meter; ``iteration`` is the step it belongs to (a
        TensorboardLogger's x axis)."""
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def close(self):
        pass

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {m.median:.4f} ({m.global_avg:.4f})"
            for name, m in self.meters.items())


class TensorboardLogger(MetricLogger):
    """A MetricLogger that also writes every update as scalars to
    ``log_dir`` (reference TensorboardLogger, metric_logger.py:68-99).
    Without an importable tensorboard it warns once and keeps the meters
    only."""

    def __init__(self, log_dir: str, start_iter: int = 0,
                 delimiter: str = "  "):
        super().__init__(delimiter)
        self.iteration = start_iter
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            log.warning("--use-tensorboard: tensorboard is not importable "
                        "(%s); logging the meters only", e)
            self.writer = None
        else:
            self.writer = SummaryWriter(log_dir)

    def update(self, iteration: int | None = None, **kwargs):
        super().update(**kwargs)
        if iteration is not None:
            self.iteration = iteration
        if self.writer is not None:
            for k, v in kwargs.items():
                self.writer.add_scalar(k, float(v), self.iteration)

    def close(self):
        if self.writer is not None:
            self.writer.close()


def eta_string(avg_iter_time: float, remaining_iters: int) -> str:
    return str(datetime.timedelta(seconds=int(avg_iter_time
                                              * remaining_iters)))


class Timer:
    """Wall-clock time over ``tic``/``toc`` pairs (reference
    utils/timer.py): ``toc`` returns the seconds since the last ``tic`` and
    adds them to ``total_time``; ``average_time`` is over ``calls``."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self) -> float:
        dt = time.perf_counter() - self.start_time
        self.total_time += dt
        self.calls += 1
        return dt

    @property
    def average_time(self) -> float:
        return self.total_time / max(self.calls, 1)
