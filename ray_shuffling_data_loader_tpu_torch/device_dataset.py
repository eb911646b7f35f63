"""Device batch delivery: shuffled batches as tensors on the GPU.

A stager thread pulls exact-size host batches from
:class:`~.dataset.ShufflingDataset`, converts them to 32-bit device dtypes
and starts their host-to-device copies ahead of the training step; a
bounded ring of ``prefetch_depth`` batches is the backpressure.

**Packed staging.** When every column is a flat 4-byte value (the DLRM
schema after int64 -> int32 narrowing), a batch is packed into one
``[n_cols + 1, B]`` int32 host buffer, features first and the label last,
float columns as their bit patterns. On CUDA the buffer is one of
``prefetch_depth`` pinned buffers, copied with ``non_blocking=True`` on a
side stream that records an event; the consumer's stream waits on that
event before it touches the batch, and a pinned buffer is refilled only
after the event of its previous copy has completed. On the device the
batch unpacks into row views, ``.view(torch.float32)`` for float rows:
no kernel and no copy.

**Direct staging.** A packed spec asks the shuffle for its layout
(``{"batch": B, "columns": [features..., label]}``, unless
``RSDL_DEVICE_DIRECT=off``) before the dataset is built. Reducers then
write their whole batches already in that layout, and such a batch
arrives as a view with ``.packed`` set: its contiguous
``[n_cols + 1, B]`` int32 prefix goes into the pinned buffer in one copy,
where a carried batch (the boundaries between reducers) is packed column
by column. The segment's mapping is read only by that copy, never by the
DMA. Both kinds unpack on the device in the same way.

Whether a spec is packed is decided once, from the spec: explicit non
4-byte types or per-column shapes take per-column staging. A staging
failure raises; there is no fallback from one path to another.

With the audit armed (``RSDL_AUDIT``), the stager digests every batch it
stages, carried or direct: the staged side of :mod:`.telemetry.audit`.

With metrics on (``RSDL_METRICS``) the stager counts ``h2d.batches``,
``h2d.bytes`` and ``h2d.dispatch_seconds`` (``h2d.direct_*`` for direct
batches), times its ``pack`` and ``device_put`` phases (stage
``staging``), and the consumer's waits count into
``stall_seconds{cause=upstream|staging}``; with tracing on, each staged
batch is a ``stage:h2d`` span and each wait a ``stall`` span. As the
port has no fallback between staging paths, the JAX package's
``h2d.packed_fallback`` and ``staging.fallback`` have no site here.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_shuffling_data_loader_tpu_torch import native, telemetry
from ray_shuffling_data_loader_tpu_torch.dataset import ShufflingDataset
from ray_shuffling_data_loader_tpu_torch.runtime import ColumnBatch
from ray_shuffling_data_loader_tpu_torch.shuffle import _narrow_column, device_direct_enabled
from ray_shuffling_data_loader_tpu_torch.telemetry._env import audit_plane as _audit
from ray_shuffling_data_loader_tpu_torch.telemetry import metrics as _metrics
from ray_shuffling_data_loader_tpu_torch.utils.device import DeviceLike, resolve_device

_TORCH_OF_NUMPY = {
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
}
_NUMPY_OF_TORCH = {v: k for k, v in _TORCH_OF_NUMPY.items()}


def _default_device_dtype(np_dtype: np.dtype) -> torch.dtype:
    """64-bit host columns become 32-bit on the device."""
    if np.issubdtype(np_dtype, np.integer):
        return torch.int32
    if np.issubdtype(np_dtype, np.floating):
        return torch.float32
    raise TypeError(f"unsupported column dtype {np_dtype}")


def _as_numpy_dtype(t: Any) -> np.dtype:
    if isinstance(t, torch.dtype):
        return _NUMPY_OF_TORCH[t]
    return np.dtype(t)


@dataclass
class TorchBatchSpec:
    """Feature and label layout of device batches. Types are numpy or
    torch dtypes; ``None`` means the 32-bit default."""

    feature_columns: List[str]
    label_column: str
    feature_types: Optional[List[Any]] = None
    feature_shapes: Optional[List[Optional[Tuple[int, ...]]]] = None
    label_type: Any = None
    label_shape: Optional[Tuple[int, ...]] = None

    def normalize(self) -> "TorchBatchSpec":
        n = len(self.feature_columns)
        types = self.feature_types or [None] * n
        shapes = self.feature_shapes or [None] * n
        if len(types) != n or len(shapes) != n:
            raise ValueError("feature_types/feature_shapes must match feature_columns")
        return TorchBatchSpec(
            feature_columns=list(self.feature_columns),
            label_column=self.label_column,
            feature_types=[None if t is None else _as_numpy_dtype(t) for t in types],
            feature_shapes=[tuple(s) if s is not None else None for s in shapes],
            label_type=None if self.label_type is None else _as_numpy_dtype(self.label_type),
            label_shape=tuple(self.label_shape) if self.label_shape is not None else None,
        )

    def packable(self) -> bool:
        """Can every batch of this spec ride one ``[n_cols + 1, B]`` int32
        buffer? Flat columns whose device type is 4 bytes wide."""
        if self.label_shape is not None or any(s is not None for s in self.feature_shapes):
            return False
        return all(
            t is None or t.itemsize == 4 for t in (*self.feature_types, self.label_type)
        )


class HostToDeviceStats:
    """Staging counters: bytes and batches staged (``batches_direct`` from
    packed reducer output in one copy, ``batches_carried`` packed on the
    host), host time spent packing and starting copies (all batches, and
    ``put_dispatch_direct_s`` of the direct ones), the consumer's stall
    time on the ring split by cause, and peak device memory while staging.

    ``stall_upstream_s``: the stager was itself waiting on the host dataset
    (epoch window or shuffle). ``stall_staging_s``: a host batch existed and
    the pack and copy ran behind the consumer."""

    def __init__(self):
        self.bytes_staged = 0
        self.batches_staged = 0
        self.batches_direct = 0
        self.batches_carried = 0
        self.put_dispatch_s = 0.0
        self.put_dispatch_direct_s = 0.0
        self.stall_s = 0.0
        self.stalls = 0
        self.stall_upstream_s = 0.0
        self.stall_staging_s = 0.0
        self.first_batch_s: Optional[float] = None
        self.peak_device_bytes_in_use = 0

    def sample_device_memory(self, device: torch.device) -> None:
        if device.type == "cuda":
            self.peak_device_bytes_in_use = max(
                self.peak_device_bytes_in_use, torch.cuda.max_memory_allocated(device)
            )

    def as_dict(self) -> Dict[str, float]:
        return {
            "bytes_staged": self.bytes_staged,
            "batches_staged": self.batches_staged,
            "batches_direct": self.batches_direct,
            "batches_carried": self.batches_carried,
            "put_dispatch_s": self.put_dispatch_s,
            "put_dispatch_direct_s": self.put_dispatch_direct_s,
            "stall_s": self.stall_s,
            "stalls": self.stalls,
            "stall_upstream_s": self.stall_upstream_s,
            "stall_staging_s": self.stall_staging_s,
            "first_batch_s": self.first_batch_s or 0.0,
            "peak_device_bytes_in_use": self.peak_device_bytes_in_use,
        }


class _Staged:
    """One staged batch: its tensors, the device buffer they view, and the
    copy's completion event (None on the CPU)."""

    __slots__ = ("features", "label", "buffers", "event")

    def __init__(self, features, label, buffers, event):
        self.features = features
        self.label = label
        self.buffers = buffers
        self.event = event


class DeviceShufflingDataset:
    """Shuffling dataset yielding ``(features, label)`` tensors on
    ``device``: ``features`` maps each feature column to a ``[B]`` tensor.

    Arguments as :class:`~.dataset.ShufflingDataset`, plus the batch spec,
    ``device`` (the rank's device; ``None`` = ``cuda``, the current CUDA
    device; the CPU only when asked for) and
    ``prefetch_depth`` (batches staged ahead; 2 = double buffering).
    ``cache_decoded`` defaults to the shuffle's policy.
    ``drop_last`` defaults to True: a ragged final batch changes the
    step's shapes. ``stats_collector`` goes to the shuffle (see
    :class:`~.dataset.ShufflingDataset`).
    """

    def __init__(
        self,
        filenames: List[str],
        num_epochs: int,
        num_trainers: int,
        batch_size: int,
        rank: int,
        feature_columns: List[str],
        label_column: str,
        feature_types: Optional[List[Any]] = None,
        feature_shapes: Optional[List[Any]] = None,
        label_type: Any = None,
        label_shape: Optional[Tuple[int, ...]] = None,
        drop_last: bool = True,
        num_reducers: Optional[int] = None,
        max_concurrent_epochs: int = 2,
        seed: int = 0,
        queue_name: str = "BatchQueue",
        device: DeviceLike = None,
        prefetch_depth: int = 2,
        start_epoch: int = 0,
        cache_decoded: Optional[bool] = None,
        stats_collector=None,
    ):
        self.device = resolve_device(device)
        self._spec = TorchBatchSpec(
            feature_columns=feature_columns,
            label_column=label_column,
            feature_types=feature_types,
            feature_shapes=feature_shapes,
            label_type=label_type,
            label_shape=label_shape,
        ).normalize()
        self._packed = self._spec.packable()
        # Asked for before the dataset exists: rank 0's constructor starts
        # the shuffle.
        self.device_layout = self._device_layout_request(batch_size)
        self._direct_sigs: Dict[tuple, bool] = {}
        self._prefetch_depth = max(1, prefetch_depth)
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._copy_stream = torch.cuda.Stream(device=self.device)
            self._pinned: List[Optional[torch.Tensor]] = [None] * self._prefetch_depth
            self._pinned_events: List[Optional[torch.cuda.Event]] = [None] * self._prefetch_depth
            self._next_slot = 0
        self.stats = HostToDeviceStats()
        self._ds = ShufflingDataset(
            filenames,
            num_epochs,
            num_trainers,
            batch_size,
            rank,
            drop_last=drop_last,
            num_reducers=num_reducers,
            max_concurrent_epochs=max_concurrent_epochs,
            seed=seed,
            queue_name=queue_name,
            start_epoch=start_epoch,
            # Staging narrows to 32 bits anyway; narrowing at decode halves
            # every host pass.
            narrow_to_32=True,
            cache_decoded=cache_decoded,
            device_layout=self.device_layout,
            stats_collector=stats_collector,
        )

    @property
    def batch_size(self) -> int:
        return self._ds.batch_size

    @property
    def dataset(self) -> ShufflingDataset:
        """The host dataset this stages from."""
        return self._ds

    def join(self, timeout: Optional[float] = None) -> None:
        """See :meth:`ShufflingDataset.join`."""
        self._ds.join(timeout)

    def set_epoch(self, epoch: int, skip_batches: int = 0) -> None:
        """Skipped batches are suppressed before staging: no copy is paid
        for them."""
        self._ds.set_epoch(epoch, skip_batches=skip_batches)

    # -- staging --------------------------------------------------------------

    def _device_layout_request(self, batch_size: int) -> Optional[Dict[str, Any]]:
        """The staging layout to ask the shuffle for: the packed row order
        (features, then the label), or None when the spec is not packed or
        ``RSDL_DEVICE_DIRECT`` is off. One device per process takes the
        whole batch, so any batch size goes."""
        if not self._packed or not device_direct_enabled():
            return None
        spec = self._spec
        return {"batch": int(batch_size), "columns": [*spec.feature_columns, spec.label_column]}

    def _direct_ok(self, cb: ColumnBatch) -> bool:
        """Is this packed batch's prefix exactly what host staging would
        have packed: the spec's columns in its order, each in the dtype the
        spec stages (4 bytes wide)? Decided once per layout signature."""
        lay = cb.layout or {}
        sig = (tuple(lay.get("columns", ())), tuple(lay.get("dtypes", ())))
        ok = self._direct_sigs.get(sig)
        if ok is None:
            spec = self._spec
            want = [*spec.feature_columns, spec.label_column]
            names, dtypes = list(sig[0]), [np.dtype(d) for d in sig[1]]
            ok = names[: len(want)] == want and len(dtypes) == len(names)
            if ok:
                for dt, want_t in zip(dtypes, (*spec.feature_types, spec.label_type)):
                    target = want_t if want_t is not None else _NUMPY_OF_TORCH[_default_device_dtype(dt)]
                    if dt != target or dt.itemsize != 4:
                        ok = False
                        break
            self._direct_sigs[sig] = ok
        return ok

    @staticmethod
    def _host_column(name: str, column: np.ndarray, dtype, shape) -> np.ndarray:
        target = dtype if dtype is not None else _NUMPY_OF_TORCH[
            _default_device_dtype(column.dtype)
        ]
        if column.dtype != target:
            if column.dtype == np.int64 and target == np.int32:
                column = _narrow_column(name, column)
            else:
                column = native.narrow(column, target)
        if shape is not None:
            column = column.reshape((-1, *shape))
        return column

    def _packed_host_buffer(self, n_rows: int, rows: int) -> Tuple[torch.Tensor, int]:
        """A ``[n_rows, rows]`` int32 host buffer and its ring slot (-1 on
        the CPU, where every batch gets a fresh buffer that the "device"
        tensor then shares)."""
        if not self._cuda:
            return torch.empty((n_rows, rows), dtype=torch.int32), -1
        slot = self._next_slot
        self._next_slot = (slot + 1) % self._prefetch_depth
        event = self._pinned_events[slot]
        if event is not None:
            event.synchronize()  # the slot's previous copy has landed
        buf = self._pinned[slot]
        if buf is None or buf.numel() < n_rows * rows:
            buf = torch.empty(
                (n_rows, max(rows, self._ds.batch_size)), dtype=torch.int32, pin_memory=True
            )
            self._pinned[slot] = buf
        return buf.view(-1)[: n_rows * rows].view(n_rows, rows), slot

    def _stage(self, cb: ColumnBatch, direct: bool = False) -> _Staged:
        """Convert one batch and start its copy to the device. ``direct``:
        a packed batch (:meth:`_direct_ok`), whose ``[n_cols + 1, B]``
        prefix block goes into the pinned slot in one copy. Otherwise the
        columns are converted and packed one by one (an unpacked spec:
        copied column by column)."""
        spec = self._spec
        prof = telemetry.stage_profiler("staging")
        # The phases are the JAX stager's: a direct batch is one
        # ``device_put`` (here its copy into the pinned buffer and the
        # copy's start); a carried one ``pack``s its columns, then packs
        # them into one buffer, then starts the copy.
        if direct:
            block = cb.packed[: len(spec.feature_columns) + 1]
            with prof.phase("device_put", nbytes=block.nbytes):
                host, slot = self._packed_host_buffer(*block.shape)
                np.copyto(host.numpy(), block)
                dev, event = self._to_device([host])
            dtypes = [_TORCH_OF_NUMPY[np.dtype(d)] for d in cb.layout["dtypes"][: len(block)]]
        else:
            with prof.phase("pack") as ph:
                cols = [
                    self._host_column(name, cb[name], dtype, shape)
                    for name, dtype, shape in zip(
                        spec.feature_columns, spec.feature_types, spec.feature_shapes
                    )
                ]
                cols.append(
                    self._host_column(spec.label_column, cb[spec.label_column], spec.label_type, spec.label_shape)
                )
                ph.add_bytes(sum(c.nbytes for c in cols))
            dtypes = [_TORCH_OF_NUMPY[c.dtype] for c in cols]
            if not self._packed:
                # Store-backed columns are read-only views of a mapped segment.
                with prof.phase("device_put"):
                    dev, event = self._to_device(
                        [torch.from_numpy(np.require(c, requirements=("C", "W"))) for c in cols]
                    )
                self.stats.bytes_staged += sum(c.nbytes for c in cols)
                return _Staged(dict(zip(spec.feature_columns, dev[:-1])), dev[-1], dev, event)
            with prof.phase("pack") as ph:
                host, slot = self._packed_host_buffer(len(cols), cb.num_rows)
                host_np = host.numpy()
                for i, c in enumerate(cols):
                    host_np[i] = c.view(np.int32)
                ph.add_bytes(host.numel() * 4)
            with prof.phase("device_put", nbytes=host.numel() * 4):
                dev, event = self._to_device([host])
        if slot >= 0:
            self._pinned_events[slot] = event
        packed = dev[0]
        rows = [packed[i] if dt == torch.int32 else packed[i].view(dt) for i, dt in enumerate(dtypes)]
        self.stats.bytes_staged += host.numel() * 4
        return _Staged(dict(zip(spec.feature_columns, rows[:-1])), rows[-1], dev, event)

    def _release_staging(self) -> None:
        """After a failed epoch (the shuffle's error, raised to the
        consumer): wait for the side stream's copies, then drop the pinned
        ring and the stream. A later epoch makes them again."""
        if not self._cuda or self._copy_stream is None:
            return
        self._copy_stream.synchronize()
        self._copy_stream = None
        self._pinned = [None] * self._prefetch_depth
        self._pinned_events = [None] * self._prefetch_depth

    def _to_device(self, host: List[torch.Tensor]):
        """Start the copies on the side stream; returns the device tensors
        and the event that marks their completion."""
        if not self._cuda:
            return host, None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self.device)
        with torch.cuda.stream(self._copy_stream):
            dev = [t.to(self.device, non_blocking=True) for t in host]
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return dev, event

    def _hand_over(self, item: _Staged) -> None:
        """Make the consumer's stream wait for the copy, and tell the
        allocator the buffers are in use there."""
        if item.event is None:
            return
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(item.event)
        for t in item.buffers:
            t.record_stream(stream)

    # -- iteration ------------------------------------------------------------

    def __iter__(self):
        """Yield device batches through the prefetch ring.

        Stall accounting: time the consumer blocks on the ring, charged to
        what the stager was doing when the wait began."""
        ring: "queue.Queue" = queue.Queue(maxsize=self._prefetch_depth)
        sentinel = object()
        cancel = threading.Event()
        error: List[BaseException] = []
        epoch_start = time.perf_counter()
        phase = ["upstream"]
        metered = _metrics.enabled()
        if metered:
            # Resolved up front: a run with no stall reports 0.0, not a
            # missing key.
            reg = _metrics.registry
            stall_counter = {cause: reg.counter("stall_seconds", cause=cause) for cause in ("upstream", "staging")}
            h2d_bytes, h2d_batches = reg.counter("h2d.bytes"), reg.counter("h2d.batches")
            h2d_dispatch = reg.histogram("h2d.dispatch_seconds")

        # The audit's staged side: each post-re-cut batch, recorded before
        # the stager takes the next, so every record is in before the
        # dataset's last acks let the driver reconcile.
        audit_on = _audit.enabled()
        epoch, rank = self._ds._epoch, self._ds._rank
        staged_rows = 0

        def stager():
            nonlocal staged_rows
            try:
                for cb in self._ds:
                    if cancel.is_set():
                        # The consumer left early: drain without staging so
                        # the epoch's acks still flow.
                        continue
                    if audit_on:
                        _audit.record_staged(epoch, rank, cb, staged_rows)
                        staged_rows += cb.num_rows
                    phase[0] = "staging"
                    t0 = time.perf_counter()
                    bytes0 = self.stats.bytes_staged
                    direct = cb.packed is not None and self._direct_ok(cb)
                    with telemetry.span("stage:h2d", cat="staging", epoch=epoch, batch=self.stats.batches_staged,
                                        rows=cb.num_rows):
                        item = self._stage(cb, direct)
                    dt = time.perf_counter() - t0
                    if metered:
                        nbytes = float(self.stats.bytes_staged - bytes0)
                        h2d_bytes.inc(nbytes)
                        h2d_batches.inc()
                        h2d_dispatch.observe(dt)
                        if direct:
                            _metrics.safe_inc("h2d.direct_bytes", nbytes)
                            _metrics.safe_inc("h2d.direct_batches")
                    self.stats.put_dispatch_s += dt
                    self.stats.batches_staged += 1
                    if direct:
                        self.stats.put_dispatch_direct_s += dt
                        self.stats.batches_direct += 1
                    else:
                        self.stats.batches_carried += 1
                    if self.stats.batches_staged % 8 == 0:
                        self.stats.sample_device_memory(self.device)
                    while not cancel.is_set():
                        try:
                            ring.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    phase[0] = "upstream"
            except Exception as exc:  # raised on the consumer side
                error.append(exc)
            finally:
                while True:
                    try:
                        ring.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        if cancel.is_set():
                            try:
                                ring.get_nowait()
                            except queue.Empty:
                                pass

        # The caller's job of the multi-job service rides into the stager,
        # which reads and stages for it: its consumed and staged digests are
        # the job's (the trace context does not cross threads).
        job = telemetry.ambient_job()

        def run_stager():
            if job is None:
                stager()
            else:
                with telemetry.context(job=job):
                    stager()

        thread = threading.Thread(target=run_stager, name="device-stager", daemon=True)
        thread.start()
        try:
            first = True
            while True:
                phase_at_wait = phase[0]
                t0 = time.perf_counter()
                item = ring.get()
                waited = time.perf_counter() - t0
                if first:
                    self.stats.first_batch_s = time.perf_counter() - epoch_start
                    first = False
                elif waited > 0.0005:
                    self.stats.stall_s += waited
                    self.stats.stalls += 1
                    if phase_at_wait == "staging":
                        self.stats.stall_staging_s += waited
                    else:
                        self.stats.stall_upstream_s += waited
                    if telemetry.traced():
                        telemetry.record_span("stall", time.time() - waited, waited, cat="staging", epoch=epoch,
                                              cause=phase_at_wait)
                    if metered:
                        stall_counter[phase_at_wait].inc(waited)
                if item is sentinel:
                    break
                self._hand_over(item)
                yield item.features, item.label
        finally:
            cancel.set()
            while True:
                try:
                    if ring.get_nowait() is sentinel:
                        break
                except queue.Empty:
                    if not thread.is_alive():
                        break
                    time.sleep(0.01)
            thread.join()
            if error:
                self._release_staging()
                raise error[0]
