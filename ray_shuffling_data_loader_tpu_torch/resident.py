"""The device-resident loader: the dataset staged once in device memory,
each epoch's shuffle a permutation and gathers on the device.

When the narrowed dataset fits a budgeted share of the card's memory
(:func:`fits_device`), the host shuffle has nothing left to do after
staging:

* **stage once**: the worker pool decodes the Parquet files and narrows
  64-bit columns to 32 bits; this process packs their rows into int32 pieces
  of ``piece_rows`` rows and copies each piece into one ``[n_cols, n +
  piece_rows]`` int32 buffer on the device, so decode, packing and the
  host-to-device copies overlap;
* **shuffle on the device**: every epoch's order is
  :func:`~.utils.prng.epoch_permutation`, the JAX package's
  ``jax.random.permutation`` draw bit for bit, and batches are gathers
  through it;
* **deliver without the host**: a batch's rows are unpacked into the
  feature dict by views (``.view(torch.float32)`` for float columns).

The contract is the shuffle's: every row once per epoch across the ranks,
an order that depends only on ``(seed, epoch)``, a contiguous slice of the
epoch's order per rank, ``drop_last``, and ``skip_batches`` to resume
mid-epoch. Given the same files, columns and seed, the batch stream is the
JAX package's :class:`DeviceResidentShufflingDataset`'s, bit for bit.

:func:`make_fused_epoch` trains a whole epoch with one captured CUDA
graph replayed once per batch.

This module covers one process with one device; the JAX package's pod
staging and its multi-device fused epoch are not ported.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_shuffling_data_loader_tpu_torch import runtime
from ray_shuffling_data_loader_tpu_torch.device_dataset import _TORCH_OF_NUMPY, HostToDeviceStats
from ray_shuffling_data_loader_tpu_torch.runtime import ActorDiedError
from ray_shuffling_data_loader_tpu_torch.shuffle import _decode_narrow_to_store, _open_parquet_file
from ray_shuffling_data_loader_tpu_torch.utils.device import DeviceLike, resolve_device
from ray_shuffling_data_loader_tpu_torch.utils.prng import epoch_permutation

# Rows per staged piece: large enough to amortize a copy's fixed costs,
# small enough that the pinned pieces (piece_rows x n_cols x 4 B, about
# 88 MB at 21 columns) stay small next to the dataset.
DEFAULT_PIECE_ROWS = 1 << 20
# Pinned host pieces in rotation: one is packed while the other copies.
PIECES_IN_FLIGHT = 2
# Steps a fused epoch runs before its capture (their updates are undone).
FUSED_WARMUP_STEPS = 3


def dataset_num_rows(filenames: Sequence[str]) -> int:
    """Total rows of the Parquet files, local paths or URIs, from their
    footers (no decode)."""
    return sum(_open_parquet_file(f)[0].metadata.num_rows for f in filenames)


def packed_nbytes(num_rows: int, num_feature_columns: int) -> int:
    """Device bytes of the packed dataset: features and label, 4 B each."""
    return (num_feature_columns + 1) * 4 * num_rows


def device_memory_budget(budget_frac: float = 0.35, device: DeviceLike = None) -> Tuple[Optional[int], bool]:
    """The resident buffer's memory budget, ``(bytes, per_device)``.

    On CUDA it is ``budget_frac`` of the card's memory
    (``torch.cuda.mem_get_info``), a per-device figure. On the CPU it is
    ``budget_frac`` of the host's RAM, a total. ``RSDL_RESIDENT_BUDGET_GB``
    overrides both, as a total. ``(None, False)`` means unknown: callers
    should then not choose resident mode."""
    env = os.environ.get("RSDL_RESIDENT_BUDGET_GB")
    if env:
        return int(float(env) * 1e9), False
    dev = resolve_device(device)
    if dev.type == "cuda":
        return int(budget_frac * torch.cuda.mem_get_info(dev)[1]), True
    if dev.type != "cpu":
        return None, False
    try:
        ram = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError):
        return None, False
    return int(budget_frac * ram), False


def fits_device(
    filenames: Sequence[str],
    num_feature_columns: int,
    device: DeviceLike = None,
    budget_frac: float = 0.35,
    num_rows: Optional[int] = None,
) -> bool:
    """Can the packed dataset live in ``device``'s memory (default
    ``cuda``) within :func:`device_memory_budget`? ``num_rows`` skips the
    footer sweep when the caller knows the count.

    On the CPU the answer is no unless ``RSDL_RESIDENT_BUDGET_GB`` is set:
    there the "device" is host memory, and the host shuffle is the faster
    path. Constructing :class:`DeviceResidentShufflingDataset` directly
    opts in regardless."""
    dev = resolve_device(device)
    if dev.type == "cpu" and not os.environ.get("RSDL_RESIDENT_BUDGET_GB"):
        return False
    budget, _ = device_memory_budget(budget_frac, dev)
    if budget is None:
        return False
    if num_rows is None:
        try:
            num_rows = dataset_num_rows(filenames)
        except OSError:
            return False
    return packed_nbytes(num_rows, num_feature_columns) <= budget


class DeviceResidentShufflingDataset:
    """Shuffling dataset whose epoch shuffle runs in device memory.

    Iterate it after ``set_epoch(epoch, skip_batches=0)``: it yields
    ``(features, label)``, ``features`` mapping each feature column to a
    ``[B]`` tensor on ``device`` (default ``cuda``; the CPU only when asked
    for).

    * every row appears exactly once per epoch across all ranks;
    * the epoch's order is :func:`~.utils.prng.epoch_permutation` of
      ``(seed, epoch)``;
    * rank ``r`` of ``num_trainers`` takes a contiguous slice of it (the
      boundaries of ``np.array_split``);
    * ``drop_last=False`` yields the ragged final batch;
    * ``skip_batches`` resumes mid-epoch without gathering the skipped
      batches.

    Args:
        lookahead: batches dispatched ahead of the one consumed (device
            work runs asynchronously).
        piece_rows: rows per staged piece.
        num_rows: the dataset's row count, if known (checked against the
            rows staged).
        progress_cb: called after every staged piece.
        materialize_epoch: gather the whole epoch once and cut batches as
            contiguous slices (None: when the epoch's copy fits beside
            what the device holds, within 0.75 of its memory), else gather
            each batch through the permutation. Both give the same stream.
        stats_collector: a :class:`~.stats.TrialStatsCollector` handle:
            an epoch's permutation reports as its map, the epoch copy (or
            the gather stream) as its reduce, each batch as a consume;
            :meth:`close` reports the staging stats and the trial's end.
    """

    def __init__(
        self,
        filenames: List[str],
        num_epochs: int,
        batch_size: int,
        feature_columns: List[str],
        label_column: str,
        num_trainers: int = 1,
        rank: int = 0,
        drop_last: bool = True,
        seed: int = 0,
        device: DeviceLike = None,
        lookahead: int = 2,
        piece_rows: int = DEFAULT_PIECE_ROWS,
        num_rows: Optional[int] = None,
        progress_cb: Optional[Callable[[], None]] = None,
        materialize_epoch: Optional[bool] = None,
        stats_collector=None,
    ):
        if not filenames:
            raise ValueError("no input files")
        if not 0 <= rank < num_trainers:
            raise ValueError(f"rank {rank} outside num_trainers {num_trainers}")
        self.device = resolve_device(device)
        self.batch_size = int(batch_size)
        self.num_epochs = int(num_epochs)
        self.num_trainers = int(num_trainers)
        self.rank = int(rank)
        self.drop_last = bool(drop_last)
        self.seed = int(seed)
        self._columns = list(feature_columns) + [label_column]
        self._feature_columns = list(feature_columns)
        self._lookahead = max(1, int(lookahead))
        self._piece_rows = max(1, int(piece_rows))
        self._epoch: Optional[int] = None
        self._skip = 0
        self._closed = False
        self._perm_cache: Dict[int, torch.Tensor] = {}
        self._epoch_buf_cache: Dict[int, torch.Tensor] = {}
        # Captured fused epochs over this dataset, released by close().
        self._fused: List["_CapturedEpoch"] = []
        self._materialize = materialize_epoch
        self._progress_cb = progress_cb
        self._stats_collector = stats_collector
        self._trial_t0 = time.perf_counter()
        self.stats = HostToDeviceStats()
        self._load(list(filenames), num_rows)

    # -- staging ------------------------------------------------------------

    def _load(self, filenames: List[str], num_rows: Optional[int]) -> None:
        """Decode, narrow, pack and copy into the device buffer.

        The pool decodes a window of ``workers + 2`` files ahead of the
        packing, so decoded files do not pile up in the store. This process
        packs each file's rows into the current piece; a full piece is
        copied into the buffer at its rows. On CUDA the pieces are pinned
        and copied without blocking on a side stream; a piece is packed
        again only after its previous copy's event has completed. The
        buffer is one piece longer than the dataset, so that every piece,
        the last one too, is copied whole; the rows past the dataset are
        never gathered."""
        t0 = time.perf_counter()
        ctx = runtime.ensure_initialized()
        window = max(2, ctx.num_workers + 2)
        pending = list(filenames)
        futs: List = []
        stage_tasks = min(len(filenames), window)

        def topup():
            while pending and len(futs) < window:
                futs.append(ctx.pool.submit(_decode_narrow_to_store, pending.pop(0), self._columns, stage_tasks))

        topup()
        ncols = len(self._columns)
        self.num_rows = num_rows if num_rows is not None else dataset_num_rows(filenames)
        n = self.num_rows
        w = min(self._piece_rows, max(1, n))
        dev = self.device
        cuda = dev.type == "cuda"
        buf = torch.zeros((ncols, n + w), dtype=torch.int32, device=dev)
        if cuda:
            copy_stream = torch.cuda.Stream(device=dev)
            copy_stream.wait_stream(torch.cuda.current_stream(dev))  # the buffer's zero fill
            pieces = [torch.empty((ncols, w), dtype=torch.int32, pin_memory=True) for _ in range(PIECES_IN_FLIGHT)]
        else:
            pieces = [torch.empty((ncols, w), dtype=torch.int32)]
        events: List[Optional[torch.cuda.Event]] = [None] * len(pieces)
        self._col_dtypes: Dict[str, np.dtype] = {}
        slot, fill, cursor = 0, 0, 0
        piece = pieces[0].numpy()

        def flush():
            nonlocal slot, fill, cursor, piece
            dst = buf[:, cursor : cursor + w]
            if cuda:
                with torch.cuda.stream(copy_stream):
                    dst.copy_(pieces[slot], non_blocking=True)
                    events[slot] = torch.cuda.Event()
                    events[slot].record(copy_stream)
            else:
                dst.copy_(pieces[slot])
            self.stats.bytes_staged += ncols * fill * 4
            cursor += fill
            fill = 0
            slot = (slot + 1) % len(pieces)
            if events[slot] is not None:
                events[slot].synchronize()  # its last copy has landed
            piece = pieces[slot].numpy()
            if self._progress_cb is not None:
                self._progress_cb()

        while futs:
            ref = futs.pop(0).result()
            topup()  # keep the decode window full while this file packs
            cb = ctx.store.get_columns(ref, populate=True)
            cols = []
            for name in self._columns:
                arr = np.asarray(cb[name])
                if arr.ndim != 1 or arr.dtype.itemsize != 4 or arr.dtype not in _TORCH_OF_NUMPY:
                    raise TypeError(
                        f"resident mode needs flat 4-byte columns; {name!r} is {arr.dtype} with shape {arr.shape}"
                    )
                prev = self._col_dtypes.setdefault(name, arr.dtype)
                if prev != arr.dtype:
                    raise TypeError(f"column {name!r} dtype differs across files: {prev} vs {arr.dtype}")
                cols.append(arr.view(np.int32))
            n_i, off = cols[0].shape[0], 0
            while off < n_i:
                take = min(w - fill, n_i - off)
                if cursor + fill + take > n:
                    raise ValueError(f"the files hold more rows than num_rows says ({n})")
                for ci in range(ncols):
                    piece[ci, fill : fill + take] = cols[ci][off : off + take]
                fill += take
                off += take
                if fill == w:
                    flush()
            del cb, cols
            ctx.store.free([ref])
        if fill:
            flush()
        if cursor != n:
            raise ValueError(f"dataset streamed {cursor} rows but num_rows says {n}; a caller-provided count was wrong")
        if cuda:
            torch.cuda.current_stream(dev).wait_stream(copy_stream)
            torch.cuda.synchronize(dev)
        self._buf = buf
        self._unpack_dtypes = [_TORCH_OF_NUMPY[self._col_dtypes[c]] for c in self._columns]
        self._finalize(t0)

    def _finalize(self, t0: float) -> None:
        n = self.num_rows
        self.stats.batches_staged = 0
        self.stats.first_batch_s = time.perf_counter() - t0
        self.stats.sample_device_memory(self.device)
        # np.array_split's boundaries over the rows, computed.
        base, extra = divmod(n, self.num_trainers)
        r = self.rank
        self._rank_start = r * base + min(r, extra)
        self._rank_rows = base + (1 if r < extra else 0)
        if self._materialize is None:
            copy_bytes = len(self._columns) * 4 * n
            if self.device.type == "cuda":
                # What the device holds already (this buffer, the model,
                # the optimizer, other processes): the copy is the increment.
                free, total = torch.cuda.mem_get_info(self.device)
                self._materialize = (total - free) + copy_bytes <= 0.75 * total
            else:
                budget, _ = device_memory_budget(0.75, self.device)
                self._materialize = budget is not None and 2 * copy_bytes <= budget

    def _unpack(self, rows: torch.Tensor):
        """Packed int32 rows -> ``(features, label)`` views."""
        out = [row if dt == torch.int32 else row.view(dt) for row, dt in zip(rows, self._unpack_dtypes)]
        return dict(zip(self._feature_columns, out[:-1])), out[-1]

    def _perm(self, epoch: int) -> torch.Tensor:
        perm = self._perm_cache.get(epoch)
        if perm is None:
            self._perm_cache.clear()  # only the latest epoch's
            perm = epoch_permutation(self.seed, epoch, self.num_rows, self.device)
            self._perm_cache[epoch] = perm
        return perm

    def _epoch_buf(self, epoch: int) -> torch.Tensor:
        """The epoch's rows in its order, ``[n_cols, n]``: one gather."""
        ebuf = self._epoch_buf_cache.get(epoch)
        if ebuf is None:
            self._epoch_buf_cache.clear()  # one epoch copy at a time
            ebuf = self._buf.index_select(1, self._perm(epoch))
            self._epoch_buf_cache[epoch] = ebuf
        return ebuf

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- iteration -------------------------------------------------------------

    @property
    def num_batches(self) -> int:
        """Batches this rank yields per epoch."""
        full, rem = divmod(self._rank_rows, self.batch_size)
        return full + (1 if rem and not self.drop_last else 0)

    def set_epoch(self, epoch: int, skip_batches: int = 0) -> None:
        self._check_open()
        if not 0 <= epoch < self.num_epochs:
            raise ValueError(f"epoch {epoch} outside num_epochs {self.num_epochs}")
        self._epoch = epoch
        self._skip = int(skip_batches)

    def close(self) -> None:
        """Release the device buffers now; the dataset cannot iterate
        after this."""
        sc = self._stats_collector
        if sc is not None and not self._closed:
            try:
                sc.call_oneway("report_staging", self.rank, self.stats.as_dict())
                sc.call_oneway("trial_done", time.perf_counter() - self._trial_t0)
            except ActorDiedError:
                pass  # nobody is left to hear the report
        self._closed = True
        self._buf = None
        self._epoch_buf_cache.clear()
        self._perm_cache.clear()
        for fused in self._fused:
            fused.release()
        self._fused.clear()
        self._epoch = None

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("dataset is closed (close() released its device buffers)")

    def __iter__(self):
        self._check_open()
        if self._epoch is None:
            raise RuntimeError("set_epoch must be called before iterating")
        epoch, skip = self._epoch, self._skip
        sc = self._stats_collector
        if sc is not None:
            sc.call_oneway("epoch_start", epoch)
            sc.call_oneway("map_start", epoch)
        t_perm = time.perf_counter()
        perm = self._perm(epoch)
        if sc is not None:
            # Stage times are honest only when the device has finished;
            # without a collector nothing waits.
            self._sync()
            sc.call_oneway("map_done", epoch, time.perf_counter() - t_perm, 0.0)
            sc.call_oneway("reduce_start", epoch)
        t_shuffle = time.perf_counter()
        if self._materialize:
            ebuf = self._epoch_buf(epoch)
            if sc is not None:
                self._sync()
                sc.call_oneway("reduce_done", epoch, time.perf_counter() - t_shuffle)
        b = self.batch_size
        full, rem = divmod(self._rank_rows, b)
        widths = [b] * full
        if rem and not self.drop_last:
            widths.append(rem)
        # The consumer never waits here: the gathers are queued on the
        # device, and a slow one shows in the step's time, not as a stall.
        pending: deque = deque()
        start = self._rank_start + skip * b
        for width in widths[skip:]:
            # Checked per batch: after close() the next dispatch fails.
            self._check_open()
            if self._materialize:
                rows = ebuf[:, start : start + width]
            else:
                rows = self._buf.index_select(1, perm[start : start + width])
            pending.append(self._unpack(rows))
            start += width
            self.stats.batches_staged += 1
            if sc is not None:
                sc.call_oneway("consume", self.rank, epoch, len(self._columns) * width * 4)
            if self.stats.batches_staged % 32 == 0:
                self.stats.sample_device_memory(self.device)
            while len(pending) > self._lookahead:
                yield pending.popleft()
        if sc is not None and not self._materialize:
            # The gather schedule's "reduce": every batch's gather dispatched.
            sc.call_oneway("reduce_done", epoch, time.perf_counter() - t_shuffle)
        while pending:
            yield pending.popleft()


def make_fused_epoch(ds: DeviceResidentShufflingDataset, step: Callable) -> Callable[[int], torch.Tensor]:
    """Train one epoch of ``ds`` per call: ``run_epoch(epoch) -> losses``,
    a ``[full]`` float32 tensor on ``ds.device`` with each full batch's
    loss (a ragged final batch is not trained).

    ``step`` is the one-device :func:`~.parallel.train.make_train_step`
    step. The model and the optimizer are updated in place, so, unlike the
    JAX package's fused epoch, there is no state to pass or donate.

    On CUDA, the batch's rows, their unpacking and the step are captured
    once in a CUDA graph, here, and each ``run_epoch`` replays it once per
    batch; the optimizer must be made with ``capturable=True``
    (:func:`~.parallel.train.make_optimizer`). The batch's start row is a
    device counter that the graph advances by ``batch_size``. On the
    materialized schedule the graph reads a persistent epoch copy that
    each call refills; on the gather schedule it gathers through a
    persistent copy of the epoch's permutation. Before the capture the
    step runs ``FUSED_WARMUP_STEPS`` times on a side stream; the
    parameters and the optimizer's state are then put back, in place, as
    they were, so that an epoch makes exactly ``full`` updates. A capture
    that fails raises.

    On the CPU, ``run_epoch`` runs the same batches through the step in a
    Python loop."""
    ds._check_open()
    full = ds._rank_rows // ds.batch_size
    if ds.device.type == "cuda":
        captured = _CapturedEpoch(ds, step, full)
        ds._fused.append(captured)
        return captured.run

    def run_epoch(epoch: int) -> torch.Tensor:
        _check_epoch(ds, epoch)
        b, start0 = ds.batch_size, ds._rank_start
        perm = ds._perm(epoch)
        ebuf = ds._epoch_buf(epoch) if ds._materialize else None
        losses = torch.empty(full, dtype=torch.float32, device=ds.device)
        for i in range(full):
            s = start0 + i * b
            rows = ebuf[:, s : s + b] if ebuf is not None else ds._buf.index_select(1, perm[s : s + b])
            losses[i] = step(*ds._unpack(rows))["loss"]
        ds.stats.batches_staged += full
        return losses

    return run_epoch


def _check_epoch(ds: DeviceResidentShufflingDataset, epoch: int) -> None:
    ds._check_open()
    if not 0 <= epoch < ds.num_epochs:
        raise ValueError(f"epoch {epoch} outside num_epochs {ds.num_epochs}")


class _CapturedEpoch:
    """One epoch's step captured in a CUDA graph over persistent inputs:
    the batch counter, and the epoch copy or the permutation."""

    def __init__(self, ds: DeviceResidentShufflingDataset, step: Callable, full: int):
        optimizer = getattr(step, "optimizer", None)
        if optimizer is None:
            raise TypeError("make_fused_epoch: step must come from make_train_step (it carries its optimizer)")
        if not all(group.get("capturable") for group in optimizer.param_groups):
            raise ValueError("make_fused_epoch: the optimizer must be made with capturable=True")
        dev = ds.device
        self._ds, self._step, self._full = ds, step, full
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._optimizer = optimizer
        self._counter = torch.zeros(1, dtype=torch.int64, device=dev)
        self._offsets = torch.arange(ds.batch_size, dtype=torch.int64, device=dev) + ds._rank_start
        self._losses = torch.zeros(full, dtype=torch.float32, device=dev)
        if ds._materialize:
            self._src = torch.zeros((len(ds._columns), ds.num_rows), dtype=torch.int32, device=dev)
            self._perm = None
        else:
            self._src = ds._buf
            self._perm = torch.zeros(ds.num_rows, dtype=torch.int64, device=dev)
        if full:
            self._graph = self._capture()

    def _body(self) -> None:
        idx = self._counter * self._ds.batch_size + self._offsets
        if self._perm is not None:
            idx = self._perm.index_select(0, idx)
        features, label = self._ds._unpack(self._src.index_select(1, idx))
        loss = self._step(features, label)["loss"]
        self._losses.index_copy_(0, self._counter, loss.reshape(1).float())
        self._counter.add_(1)

    def _capture(self) -> torch.cuda.CUDAGraph:
        """Warm up, put the model and the optimizer back, capture. The
        warm-up reads rows 0.. of the (zero) inputs: any rows do, as its
        updates are undone."""
        opt = self._optimizer
        params = [p for group in opt.param_groups for p in group["params"]]
        with torch.no_grad():
            saved_params = [p.detach().clone() for p in params]
            saved_state = {p: {k: v.clone() for k, v in opt.state[p].items()} for p in params if opt.state.get(p)}
        if len(saved_state) < len(params):
            # Create the missing optimizer state before the capture: a step
            # on zero gradients, whose effects the restore below undoes.
            for p in params:
                p.grad = torch.zeros_like(p)
            opt.step()
        opt.zero_grad(set_to_none=True)
        current = torch.cuda.current_stream(self._ds.device)
        side = torch.cuda.Stream(device=self._ds.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(FUSED_WARMUP_STEPS):
                self._counter.zero_()  # rows of the first batch only
                self._body()
        current.wait_stream(side)
        with torch.no_grad():
            for p, saved in zip(params, saved_params):
                p.copy_(saved)
            for p in params:
                saved = saved_state.get(p)
                for k, v in opt.state[p].items():
                    if saved is None:
                        v.zero_()  # a fresh state: step 0, zero moments
                    else:
                        v.copy_(saved[k])
        opt.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._body()
        return graph

    def run(self, epoch: int) -> torch.Tensor:
        ds = self._ds
        _check_epoch(ds, epoch)
        if self._src is None:
            raise RuntimeError("fused epoch released (its dataset was closed)")
        if self._perm is None:
            ds._epoch_buf_cache.clear()  # one epoch copy at a time
            torch.index_select(ds._buf, 1, ds._perm(epoch), out=self._src)
        else:
            self._perm.copy_(ds._perm(epoch))
        self._counter.zero_()
        for _ in range(self._full):
            self._graph.replay()

        ds.stats.batches_staged += self._full
        return self._losses[: self._full].clone()

    def release(self) -> None:
        self._graph = self._src = self._perm = None
