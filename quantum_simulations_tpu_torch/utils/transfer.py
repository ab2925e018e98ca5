"""The card's side of stripe I/O for the out-of-core tier
(``runtime/spill.py``).

The reference's ``utils/transfer.py`` routes around a TPU tunnel that
cannot move complex arrays; none of that carries over.  Here a stripe
group crosses PCIe as interleaved complex64 (or complex128) through:

* **pinned host memory**: :func:`pinned_empty` allocates the host
  buffers page-locked, so every copy to and from them is asynchronous
  DMA.  Where the allocation is refused, the buffer stays pageable and
  CUDA stages its copies (slower, and synchronous from the device);
  ``HostBuffer.pinned`` (``stats["pinned"]`` of a spill run) says which.
* **three streams**: one copy stream host -> device, one device ->
  host, and the compute stream (the current stream, where the kernels
  launch), ordered by CUDA events only.
* **fixed device slots**: a ring of two complex slots allocated once
  per run.  A slot is written by the upload stream, computed on the
  compute stream and read by the download stream; each hand-over waits
  for the event of the stream before, and an upload into a slot waits
  for that slot's last download.  No buffer a copy still reads ever
  returns to the caching allocator mid-run.

On the CPU (the tests) the same calls copy synchronously.
"""
from __future__ import annotations

import numpy as np
import torch

# Bytes of one copy command: a stripe moves as pieces of at most this
# size, so a small copy the compute stream makes meanwhile (a plain
# gate's table) waits for one piece on the copy engine, not a stripe.
COPY_CHUNK = 256 << 20


def pinned_empty(count: int, dtype, device: torch.device):
    """``(array, pinned)``: a host numpy array of ``count`` elements,
    page-locked when ``device`` is a card and CUDA grants it (the
    array is a view of a pinned torch tensor, which it keeps alive)."""
    dtype = np.dtype(dtype)
    if device.type == "cuda":
        try:
            t = torch.empty(count * dtype.itemsize, dtype=torch.uint8,
                            pin_memory=True)
        except RuntimeError:
            pass
        else:
            return t.numpy().view(dtype), True
    return np.empty(count, dtype=dtype), False


def release_pinned_cache() -> None:
    """Return the pinned blocks no tensor holds any more to the system:
    the caching host allocator keeps freed pinned memory for reuse, which
    at n = 33 is a 64 GiB block."""
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None and torch.cuda.is_available():
        empty()


class StripeIO:
    """A ring of two device slots of ``slot_len`` complex amplitudes and
    the streams that fill, compute and drain them.

    ``f32=True`` moves every stripe as its interleaved float32 view (the
    reference's ``transfer='f32'``): the same bytes, so the same result.
    ``bytes_up`` / ``bytes_down`` count what crossed each way.
    """

    def __init__(self, device: torch.device, cdtype: torch.dtype,
                 slot_len: int, *, f32: bool = False):
        self.dev = device
        self.cdtype = cdtype
        self.f32 = f32
        self.slots = [torch.empty(slot_len, dtype=cdtype, device=device)
                      for _ in range(2)]
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.compute = torch.cuda.current_stream(device)
            self.h2d = torch.cuda.Stream(device)
            self.d2h = torch.cuda.Stream(device)
            ev = torch.cuda.Event
            self.uploaded = [ev(), ev()]
            self.computed = [ev(), ev()]
            self.drained = [ev(), ev()]
        self.bytes_up = 0
        self.bytes_down = 0

    def _dev_view(self, x: torch.Tensor) -> torch.Tensor:
        return torch.view_as_real(x).reshape(-1) if self.f32 else x

    def _host_view(self, a) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
        return torch.view_as_real(t).reshape(-1) if self.f32 else t

    def _pieces(self, i: int, arrays):
        """(host piece, device piece) pairs of the stripes ``arrays`` laid
        one after another into slot ``i``, each at most COPY_CHUNK bytes."""
        slot = self.slots[i]
        off = 0
        for a in arrays:
            item = a.itemsize if isinstance(a, np.ndarray) else a.element_size()
            step = max(1, COPY_CHUNK // item)
            for lo in range(0, len(a), step):
                hi = min(lo + step, len(a))
                yield a[lo:hi], slot[off + lo:off + hi]
            off += len(a)

    def upload(self, i: int, arrays) -> None:
        """Copy the host stripes ``arrays``, one after another, into slot
        ``i`` (after the slot's last download)."""
        if self.cuda:
            self.h2d.wait_event(self.drained[i])
            with torch.cuda.stream(self.h2d):
                for a, d in self._pieces(i, arrays):
                    self._dev_view(d).copy_(self._host_view(a),
                                            non_blocking=True)
            self.uploaded[i].record(self.h2d)
        else:
            for a, d in self._pieces(i, arrays):
                self._dev_view(d).copy_(self._host_view(a))
        self.bytes_up += sum(a.nbytes for a in arrays)

    def compute_slot(self, i: int, count: int, body) -> None:
        """Run ``body([re, im]) -> (re, im)`` on the first ``count``
        amplitudes of slot ``i``: split into planes on the card, joined
        back into the slot, on the compute stream."""
        if self.cuda:
            self.compute.wait_event(self.uploaded[i])
        x = torch.view_as_real(self.slots[i][:count])
        re, im = body([x[:, 0].contiguous(), x[:, 1].contiguous()])
        x[:, 0].copy_(re)
        x[:, 1].copy_(im)
        del re, im
        if self.cuda:
            self.computed[i].record(self.compute)

    def download(self, i: int, arrays) -> None:
        """Copy slot ``i`` back into the host stripes ``arrays`` (numpy
        arrays or pinned tensors), one after another, once computed."""
        if self.cuda:
            self.d2h.wait_event(self.computed[i])
            with torch.cuda.stream(self.d2h):
                for a, d in self._pieces(i, arrays):
                    self._host_view(a).copy_(self._dev_view(d),
                                             non_blocking=True)
            self.drained[i].record(self.d2h)
        else:
            for a, d in self._pieces(i, arrays):
                self._host_view(a).copy_(self._dev_view(d))
        self.bytes_down += sum(a.nbytes for a in arrays)

    def wait(self, i: int) -> None:
        """Block the host until slot ``i``'s download has landed."""
        if self.cuda:
            self.drained[i].synchronize()

    def staging(self, count: int, length: int) -> list:
        """``count`` host stripes of ``length`` (tensors, pinned on the
        card) to download into when the destination is not a host buffer
        (the disk backend)."""
        return [torch.empty(length, dtype=self.cdtype, pin_memory=self.cuda)
                for _ in range(count)]
