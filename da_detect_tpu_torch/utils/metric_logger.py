"""Metric logging (the port's own copy of what the training loop needs from
``da_detect_tpu/utils/metric_logger.py``): windowed median and global mean
of each meter, and the ETA string."""

from __future__ import annotations

import datetime
from collections import defaultdict, deque


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

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {m.median:.4f} ({m.global_avg:.4f})"
            for name, m in self.meters.items())


def eta_string(avg_iter_time: float, remaining_iters: int) -> str:
    return str(datetime.timedelta(seconds=int(avg_iter_time
                                              * remaining_iters)))
