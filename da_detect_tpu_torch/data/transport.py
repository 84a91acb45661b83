"""Host -> device transport of a step's batch (the effect of the JAX
package's ``data/packing.py::BatchPacker``: one copy a step, not one a
tensor).

``Transport(device, packed=True, depth=d)``: ``send(batch)`` runs on the
loader's producer thread. It packs every tensor of the batch (a tuple of
``ImageBatch``/``Targets``) into one uint8 buffer, each at an offset aligned
to 8 bytes, and copies it to the device with ``non_blocking=True`` on a side
stream. ``receive(shipment)`` runs on the consumer's thread: its current
stream waits on the copy's event, ``record_stream`` keeps the device buffer
from the allocator until that stream's work on it is done, and the tensors
come back as views of the buffer at their offsets (``Tensor.view(dtype)`` on
byte slices: no tensor is converted). Images travel in NHWC byte order and
come back as the channels-last NCHW view the model takes.

On the card the host side is a ring of ``depth + 1`` pinned buffers,
allocated once; a buffer is packed again only after the event of its last
copy has completed, so a slow consumer can never see a buffer half
overwritten. On the CPU (tests) each batch packs into a buffer of its own,
and the views are the result.

``packed=False`` copies tensor by tensor (``TPU.PACKED_TRANSPORT`` off).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import defaultdict

import torch

_ALIGN = 8


@dataclasses.dataclass
class _Leaf:
    item: int
    field: str
    dtype: torch.dtype
    shape: tuple          # as the consumer sees it (NCHW for images)
    nhwc: bool            # 4-D: bytes in NHWC order, rebuilt as a permute
    offset: int
    nbytes: int


def _layout(batch: tuple) -> tuple[list[_Leaf], int]:
    leaves, total = [], 0
    for i, item in enumerate(batch):
        for f in dataclasses.fields(item):
            x = getattr(item, f.name)
            if x is None:  # an absent optional leaf (Targets.masks)
                continue
            total = -(-total // _ALIGN) * _ALIGN
            n = x.numel() * x.element_size()
            leaves.append(_Leaf(i, f.name, x.dtype, tuple(x.shape),
                                x.dim() == 4, total, n))
            total += n
    return leaves, total


def _bytes(x: torch.Tensor, nhwc: bool) -> torch.Tensor:
    if nhwc:
        x = x.permute(0, 2, 3, 1)
    return x.contiguous().reshape(-1).view(torch.uint8)


def _views(batch_types: tuple, leaves: list[_Leaf],
           buf: torch.Tensor) -> tuple:
    fields = [dict() for _ in batch_types]
    for leaf in leaves:
        x = buf[leaf.offset:leaf.offset + leaf.nbytes].view(leaf.dtype)
        if leaf.nhwc:
            n, c, h, w = leaf.shape
            x = x.view(n, h, w, c).permute(0, 3, 1, 2)
        else:
            x = x.view(leaf.shape)
        fields[leaf.item][leaf.field] = x
    return tuple(t(**f) for t, f in zip(batch_types, fields))


@dataclasses.dataclass
class Shipment:
    """A batch on its way: the device buffer, its layout and the copy's
    event (packed), or the batch itself (per tensor)."""
    batch_types: tuple
    leaves: list = None
    buf: torch.Tensor = None
    event: torch.cuda.Event = None
    batch: tuple = None


class Transport:
    def __init__(self, device, packed: bool = True, depth: int = 2):
        self.device = torch.device(device)
        self.packed = packed
        self.stats: dict[str, float] = defaultdict(float)
        self._lock = threading.Lock()
        self._cuda = self.device.type == "cuda"
        if packed and self._cuda:
            self._stream = torch.cuda.Stream(self.device)
            self._ring: list = [None] * (depth + 1)
            self._events: list = [None] * (depth + 1)
            self._sent = 0

    def _tick(self, key: str, t0: float) -> None:
        with self._lock:
            self.stats[key] += time.perf_counter() - t0

    def send(self, batch: tuple) -> Shipment:
        """Producer side: start the batch's copy to the device."""
        types = tuple(type(item) for item in batch)
        if not self.packed:
            t0 = time.perf_counter()
            moved = tuple(item.to(self.device) for item in batch)
            self._tick("put_s", t0)
            return Shipment(types, batch=moved)
        t0 = time.perf_counter()
        leaves, total = _layout(batch)
        if self._cuda:
            slot = self._sent % len(self._ring)
            self._sent += 1
            if self._events[slot] is not None:
                self._events[slot].synchronize()  # its last copy is done
            host = self._ring[slot]
            if host is None or host.numel() < total:
                host = self._ring[slot] = torch.empty(
                    total, dtype=torch.uint8, pin_memory=True)
        else:
            host = torch.empty(total, dtype=torch.uint8)
        for leaf in leaves:
            x = getattr(batch[leaf.item], leaf.field)
            host[leaf.offset:leaf.offset + leaf.nbytes] = _bytes(x, leaf.nhwc)
        self._tick("pack_s", t0)
        with self._lock:
            self.stats["bytes"] = total
        if not self._cuda:
            return Shipment(types, leaves, host)
        t0 = time.perf_counter()
        with torch.cuda.stream(self._stream):
            buf = torch.empty(total, dtype=torch.uint8, device=self.device)
            buf.copy_(host[:total], non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._events[slot] = event
        self._tick("put_s", t0)
        return Shipment(types, leaves, buf, event)

    def receive(self, shipment: Shipment) -> tuple:
        """Consumer side: the batch's tensors on the device, ordered after
        the copy on the consumer's current stream."""
        if shipment.batch is not None:
            return shipment.batch
        if shipment.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(shipment.event)
            shipment.buf.record_stream(stream)
        return _views(shipment.batch_types, shipment.leaves, shipment.buf)
