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

**Pods.** Given a ``mesh`` (:func:`~.parallel.make_mesh`) over a
``torch.distributed`` world of more than one process, every process holds
one device and walks the same global batch stream (``batch_size`` is the
global batch), as the JAX package's multi-controller pod does: the rank at
data index ``d`` of ``D`` stages only its span ``[d * padded / D, (d + 1)
* padded / D)`` of the rows (``padded = ceil(n / D) * D``), decoding on
its own pool just the row groups that overlap it, and yields rows ``[d * B
/ D, (d + 1) * B / D)`` of every global batch of ``B`` rows (the JAX
package's ``P("data")`` output sharding); model peers of one data index
yield the same shard. The rows cross between processes in an uneven
all-to-all over the data group (:func:`~.parallel.collectives.
all_to_all_uneven`): once an epoch on the materialized schedule, into the
scan layout ``[batches, n_cols, B / D]``, or once a batch on the gather
schedule. :func:`fits_device` votes over the world with
``pod_consistent=True``, and process 0's choice of schedule is broadcast,
since the two schedules make different collectives.
"""

from __future__ import annotations

import hashlib
import math
import os
import socket
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ray_shuffling_data_loader_tpu_torch import runtime
from ray_shuffling_data_loader_tpu_torch.device_dataset import _TORCH_OF_NUMPY, HostToDeviceStats
from ray_shuffling_data_loader_tpu_torch.parallel import collectives
from ray_shuffling_data_loader_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from ray_shuffling_data_loader_tpu_torch.parallel.train import bce_loss
from ray_shuffling_data_loader_tpu_torch.runtime import ActorDiedError
from ray_shuffling_data_loader_tpu_torch.shuffle import (  # noqa: F401  (the pod's pool task, re-exported)
    _decode_narrow_range_to_store,
    _decode_narrow_to_store,
    _open_parquet_file,
    narrowed_dtype,
)
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
    return sum(m.num_rows for m in _file_metadata(filenames))


def _file_metadata(filenames: Sequence[str]) -> list:
    """Each file's Parquet footer (``FileMetaData``), local paths or URIs."""
    return [_open_parquet_file(f)[0].metadata for f in filenames]


def _world_size() -> int:
    """The ``torch.distributed`` world's size, 1 when none is initialized."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _stream_digest(filenames: Sequence[str], metas: Sequence) -> List[int]:
    """The stream's identity as four 32-bit words, built as the JAX
    package's pod staging builds it: each file's basename (not its path:
    hosts may mount one dataset at different paths) and footer (rows,
    writer, footer size, schema, rows of each row group), through
    blake2s."""
    parts: List[str] = []
    for f, meta in zip(filenames, metas):
        parts.extend((
            os.path.basename(f),
            str(meta.num_rows),
            str(meta.created_by),
            str(meta.serialized_size),
            # Not str(meta.schema): its repr leads with an address.
            str(meta.schema.to_arrow_schema()),
            *(str(meta.row_group(i).num_rows) for i in range(meta.num_row_groups)),
        ))
    digest16 = hashlib.blake2s("\x00".join(parts).encode()).digest()[:16]
    return [int(w) for w in np.frombuffer(digest16, dtype=np.uint32)]


def _device_identity(device: torch.device) -> int:
    """A 63-bit name of this process's device (its host and index): ranks
    with equal names share one device's memory."""
    index = device.index if device.index is not None else (
        torch.cuda.current_device() if device.type == "cuda" else 0)
    name = f"{socket.gethostname()}/{device.type}:{index}".encode()
    return int.from_bytes(hashlib.blake2s(name).digest()[:8], "little") >> 1


def _check_batch_axis(batch_axis: str) -> None:
    if batch_axis != DATA_AXIS:
        raise ValueError(f"batch_axis must be the mesh's {DATA_AXIS!r} axis, got {batch_axis!r}")


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
    mesh: Optional[Mesh] = None,
    batch_axis: str = DATA_AXIS,
    pod_consistent: bool = False,
) -> bool:
    """Can the packed dataset live in ``device``'s memory (default
    ``cuda``) within :func:`device_memory_budget`? ``num_rows`` skips the
    footer sweep when the caller knows the count.

    On the CPU the answer is no unless ``RSDL_RESIDENT_BUDGET_GB`` is set:
    there the "device" is host memory, and the host shuffle is the faster
    path. Constructing :class:`DeviceResidentShufflingDataset` directly
    opts in regardless.

    In a ``torch.distributed`` world of more than one process the answer
    is ``False`` unless the caller declares the call collective
    (``pod_consistent=True``: every process calls it at the same point).
    Then every process answers for itself, the answers are all-gathered,
    and the result is their minimum, so a pod never splits across
    delivery paths. A rank's share of the buffer is ``1 / D`` of it over
    ``mesh``'s data axis of ``D``, so the per-device budget is held
    against that share, but only where every rank has a device of its
    own: ranks that share one card (gloo ranks on ``cuda:0``) share its
    memory, and the whole buffer is held against the one budget."""
    if _world_size() > 1:
        if not pod_consistent:
            return False
        _check_batch_axis(batch_axis)
        dev = resolve_device(device)
        shares = mesh.data_size if mesh is not None else 1
        whole, share = _fits_device_local(filenames, num_feature_columns, dev, budget_frac, num_rows, shares)
        votes = collectives.all_gather_ints([_device_identity(dev), int(whole), int(share)], dist.group.WORLD)
        own_device = len({v[0] for v in votes}) == len(votes)
        return bool(min(v[2] if own_device else v[1] for v in votes))
    return _fits_device_local(filenames, num_feature_columns, resolve_device(device), budget_frac, num_rows, 1)[0]


def _fits_device_local(
    filenames: Sequence[str],
    num_feature_columns: int,
    dev: torch.device,
    budget_frac: float,
    num_rows: Optional[int],
    shares: int,
) -> Tuple[bool, bool]:
    """This process's answers: ``(whole buffer fits, 1 / shares of it
    fits)``; the second divides only a per-device budget."""
    if dev.type == "cpu" and not os.environ.get("RSDL_RESIDENT_BUDGET_GB"):
        return False, False
    budget, per_device = device_memory_budget(budget_frac, dev)
    if budget is None:
        return False, False
    if num_rows is None:
        try:
            num_rows = dataset_num_rows(filenames)
        except OSError:
            return False, False
    need = packed_nbytes(num_rows, num_feature_columns)
    return need <= budget, need / (shares if per_device else 1) <= budget


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
        mesh: this rank's :class:`~.parallel.mesh.Mesh`. In a world of
            more than one process the dataset is a pod's (module
            docstring): every process must construct it, at the same
            point, with the same files in the same order (a digest of
            them is all-gathered and a mismatch raises on every process),
            ``num_trainers`` must be 1, and each yielded batch is this
            data index's shard of the global batch. Every column must
            narrow to 4 bytes, by the schema. A batch width that the data
            axis does not divide raises ``ValueError`` where that batch is
            dispatched, as the JAX package's sharded batch does.
            ``exchange_seconds[epoch]`` holds the host seconds of an
            epoch's exchanges. Without a mesh, or in a world of one, the
            dataset is the one-process one.
        batch_axis: the mesh axis the batch is split over (the JAX name);
            only ``"data"``.
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
        mesh: Optional[Mesh] = None,
        batch_axis: str = DATA_AXIS,
    ):
        self._pod = mesh is not None and _world_size() > 1
        if self._pod and num_trainers != 1:
            # Every process walks the one global stream and takes its shard
            # of each batch: the rank lives in the mesh, not in the split.
            raise ValueError(
                "a pod's resident dataset is one global stream; use num_trainers=1 (each process yields its "
                "shard of every global batch)"
            )
        if not filenames:
            raise ValueError("no input files")
        if not 0 <= rank < num_trainers:
            raise ValueError(f"rank {rank} outside num_trainers {num_trainers}")
        _check_batch_axis(batch_axis)
        self.mesh = mesh
        self.batch_axis = batch_axis
        self.exchange_seconds: Dict[int, float] = {}
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
        never gathered. A pod's process stages its span instead
        (:meth:`_load_multiprocess`)."""
        if self._pod:
            self._load_multiprocess(filenames, num_rows)
            return
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

    def _load_multiprocess(self, filenames: List[str], num_rows: Optional[int]) -> None:
        """A pod's staging: this process decodes, on its own pool (never
        the cluster's: segments published on other hosts would come
        straight back), only the rows of its data index's span, at
        row-group granularity, into one ``[n_cols, span]`` int32 buffer on
        its device. The rows past the dataset in the last span are zeros
        and never gathered. Model peers stage the same span."""
        t0 = time.perf_counter()
        ctx = runtime.ensure_initialized()
        ncols = len(self._columns)
        size, index = self.mesh.data_size, self.mesh.data_index
        metas = _file_metadata(filenames)
        file_rows = [m.num_rows for m in metas]
        n = sum(file_rows)
        if num_rows is not None and num_rows != n:
            raise ValueError(f"dataset has {n} rows but num_rows says {num_rows}")
        self.num_rows = n
        # Every process maps row offsets from its own file order: one that
        # differs would assemble another dataset. All-gathered, not
        # broadcast, so that every process raises and none waits in the
        # next collective for one that did.
        ident = _device_identity(self.device)
        votes = collectives.all_gather_ints([*_stream_digest(filenames, metas), ident], dist.group.WORLD)
        if len({tuple(v[:4]) for v in votes}) != 1:
            raise ValueError("file list (order/rows) differs across processes; all processes must pass the "
                             "identical sequence of files")
        # Ranks whose device is this one's: their epoch copies share its memory.
        self._device_sharers = sum(1 for v in votes if v[4] == ident)
        # Column dtypes by the schema, the same on every process whatever
        # files it decodes.
        self._col_dtypes = {}
        schema = _open_parquet_file(filenames[0])[0].schema_arrow
        for name in self._columns:
            narrowed = narrowed_dtype(np.dtype(schema.field(name).type.to_pandas_dtype()))
            if narrowed.itemsize != 4 or narrowed not in _TORCH_OF_NUMPY:
                raise TypeError(f"resident mode needs 4-byte columns; {name!r} decodes to {narrowed}")
            self._col_dtypes[name] = narrowed
        padded = math.ceil(n / size) * size
        span = padded // size
        lo, hi = index * span, (index + 1) * span
        self._padded_rows, self._span = padded, span
        local = np.zeros((ncols, span), np.int32)
        offsets = np.concatenate([[0], np.cumsum(file_rows)]).astype(np.int64)
        overlaps = [(i, max(lo, int(offsets[i])), min(hi, int(offsets[i + 1]))) for i in range(len(filenames))]
        overlaps = [(i, a, b) for i, a, b in overlaps if a < b]
        futs = [
            ctx.pool.submit(_decode_narrow_range_to_store, filenames[i], self._columns, a - int(offsets[i]),
                            b - int(offsets[i]), len(overlaps))
            for i, a, b in overlaps
        ]
        for fut, (i, a, b) in zip(futs, overlaps):
            ref = fut.result()
            cb = ctx.store.get_columns(ref, populate=True)
            for ci, name in enumerate(self._columns):
                arr = np.asarray(cb[name])
                if arr.dtype != self._col_dtypes[name]:
                    raise TypeError(f"column {name!r}: file {filenames[i]!r} decodes to {arr.dtype}, the schema "
                                    f"says {self._col_dtypes[name]}")
                local[ci, a - lo : b - lo] = arr.view(np.int32)
            self.stats.bytes_staged += ncols * (b - a) * 4
            del cb
            ctx.store.free([ref])
            if self._progress_cb is not None:
                self._progress_cb()
        self._buf = torch.from_numpy(local).to(self.device)
        self._sync()
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
            ncols = len(self._columns)
            # A pod's rank holds 1 / D of the epoch copy, and the ranks
            # that share its device hold theirs beside it.
            copy_bytes = ncols * 4 * (self._span * self._device_sharers if self._pod else n)
            if self.device.type == "cuda":
                # What the device holds already (this buffer, the model,
                # the optimizer, other processes): the copy is the increment.
                free, total = torch.cuda.mem_get_info(self.device)
                decision = (total - free) + copy_bytes <= 0.75 * total
            else:
                budget, _ = device_memory_budget(0.75, self.device)
                decision = budget is not None and 2 * ncols * 4 * (self._padded_rows if self._pod else n) <= budget
            if self._pod:
                # The two schedules make different collectives, so every
                # process takes one: process 0's.
                decision = bool(collectives.broadcast_int(int(decision), dist.group.WORLD))
            self._materialize = decision

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

    # -- a pod's exchanges ------------------------------------------------------

    def _shard_width(self, width: int) -> int:
        """This data index's rows of a global batch of ``width`` rows; a
        width that the data axis does not divide raises, as a JAX array
        sharded over it does."""
        size = self.mesh.data_size
        if width % size:
            raise ValueError(f"a batch of {width} rows is sharded over a data axis of {size}: its global size "
                             f"should be divisible by {size}")
        return width // size

    def _exchange(self, epoch: int, first: int, count: int, tail: int,
                  out: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Full batches ``first .. first + count - 1`` of ``epoch``'s order
        and, with ``tail`` > 0, the ragged batch of ``tail`` rows after
        them, in one uneven all-to-all over the data group. Each process
        sends the rows of its span that other shards hold, grouped by
        destination, each group in the epoch's order; a receiver knows
        from the permutation which process holds each of its rows and puts
        them in place. Returns ``(xs, tail_shard)``: this data index's
        shard of each full batch in the scan layout ``[count, n_cols,
        batch / D]`` (written into ``out`` when given) and of the ragged
        batch, ``[n_cols, tail / D]`` (None without one)."""
        t0 = time.perf_counter()
        b, ncols, dev = self.batch_size, len(self._columns), self.device
        size, index, span = self.mesh.data_size, self.mesh.data_index, self._span
        s = self._shard_width(b) if count else 0
        t = self._shard_width(tail) if tail else 0
        pos = torch.arange(count * b + tail, device=dev)
        rows = self._perm(epoch)[first * b : first * b + pos.numel()]
        owner = torch.div(rows, span, rounding_mode="floor")
        batch = torch.div(pos, b, rounding_mode="floor")
        shard = torch.where(batch < count, max(s, 1), max(t, 1))
        dest = torch.div(pos - batch * b, shard, rounding_mode="floor")
        mine = owner == index
        send_dest = dest[mine]
        send_rows = (rows[mine] - index * span)[torch.argsort(send_dest, stable=True)]
        send = self._buf.index_select(1, send_rows).t()
        recv, got = collectives.all_to_all_uneven(send, torch.bincount(send_dest, minlength=size).tolist(),
                                                 self.mesh.data_group)
        wanted_owner = owner[dest == index]
        if got != torch.bincount(wanted_owner, minlength=size).tolist():
            raise RuntimeError(f"epoch {epoch}: the data group sent {got} rows by rank, not the rows this shard "
                               "holds; the processes disagree on the stream")
        # Received rows come by rank, each rank's in the epoch's order: the
        # stable sort of the wanted rows' owners puts them in place.
        place = torch.argsort(wanted_owner, stable=True)
        recv = recv.t()
        xs = out if out is not None else torch.empty((count, ncols, s), dtype=torch.int32, device=dev)
        tail_shard = None
        if count:
            in_xs = place < count * s
            at = place[in_xs]
            xs.permute(1, 0, 2)[:, torch.div(at, s, rounding_mode="floor"), at % s] = recv[:, in_xs]
            recv, place = recv[:, ~in_xs], place[~in_xs] - count * s
        if tail:
            tail_shard = torch.empty((ncols, t), dtype=torch.int32, device=dev)
            tail_shard[:, place] = recv
        self._sync()
        self.exchange_seconds[epoch] = self.exchange_seconds.get(epoch, 0.0) + time.perf_counter() - t0
        return xs, tail_shard

    def _pod_epoch(self, epoch: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """A pod's materialized epoch: ``(xs, tail_shard)`` of
        :meth:`_exchange` over every batch, one exchange an epoch (a
        ragged batch whose width the data axis does not divide is left out
        and raises where it is dispatched)."""
        hit = self._epoch_buf_cache.get(epoch)
        if hit is None:
            self._epoch_buf_cache.clear()  # one epoch copy at a time
            full, rem = divmod(self.num_rows, self.batch_size)
            tail = rem if rem and not self.drop_last and rem % self.mesh.data_size == 0 else 0
            hit = self._epoch_buf_cache[epoch] = self._exchange(epoch, 0, full, tail)
        return hit

    def _pod_batch(self, epoch: int, i: int, width: int, ebuf) -> torch.Tensor:
        """This data index's shard of a pod's batch ``i`` (``width``
        rows): a slice of the materialized epoch ``ebuf``, or, on the
        gather schedule (``ebuf`` None), one exchange."""
        full = self.num_rows // self.batch_size
        if ebuf is None:
            xs, tail_shard = self._exchange(epoch, i, 1, 0) if i < full else self._exchange(epoch, full, 0, width)
            return xs[0] if i < full else tail_shard
        if i < full:
            return ebuf[0][i]
        if ebuf[1] is None:
            self._shard_width(width)  # raises: the data axis does not divide the ragged batch
        return ebuf[1]

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
            ebuf = self._pod_epoch(epoch) if self._pod else self._epoch_buf(epoch)
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
        for i, width in enumerate(widths[skip:], skip):
            # Checked per batch: after close() the next dispatch fails.
            self._check_open()
            if self._pod:
                rows = self._pod_batch(epoch, i, width, ebuf if self._materialize else None)
            elif self._materialize:
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
    Python loop.

    Over a pod's processes (the counterpart of the JAX package's
    multi-device fused epoch), ``step`` is
    ``make_psum_train_step(model, optimizer, mesh.data_group)`` (the
    gradients' mean over the data group; not ``DistributedDataParallel``,
    which holds each parameter's gradient accumulator on the stream it was
    made on, where a captured backward cannot wait) and each process trains
    its shard of every global batch; the losses are the global batches'.
    On the materialized schedule the epoch is read in the scan layout that
    one exchange made, so no data moves between processes inside the
    epoch and the gradient all-reduce is the step's one collective; on the
    gather schedule each batch's exchange runs before its step. A gloo collective cannot sit inside a CUDA graph, so
    on CUDA two graphs are captured around it: the batch's slice, its
    unpacking, the forward and the backward, whose gradients (and the
    loss) land in one flat buffer; then the mean of that buffer over the
    data group into the gradients and Adam (``capturable=True``). Each
    step replays the first, all-reduces the buffer from the host
    (:func:`~.parallel.collectives.all_reduce_`), and replays the second:
    every batch makes exactly one update, as on one process. On the CPU it
    is the per-batch loop of ``step``."""
    ds._check_open()
    full = ds._rank_rows // ds.batch_size
    if ds._pod:
        return _pod_fused_epoch(ds, step, full)
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


def _pod_fused_epoch(ds: DeviceResidentShufflingDataset, step: Callable, full: int) -> Callable[[int], torch.Tensor]:
    # DistributedDataParallel holds each parameter's gradient accumulator,
    # made on the stream of its construction, and a captured backward may
    # not wait on that stream: the fused epoch makes the explicit mean.
    if (getattr(step, "group", None) is not ds.mesh.data_group or getattr(step, "grad_reduce", None) != "mean"
            or step.grad_dtype is not None):
        raise ValueError("make_fused_epoch over a pod: step must be make_psum_train_step(model, optimizer, "
                         "mesh.data_group) (the mean in the parameters' dtype), over the dataset's mesh")
    if ds.device.type == "cuda":
        captured = _CapturedPodEpoch(ds, step, full)
        ds._fused.append(captured)
        return captured.run

    def run_epoch(epoch: int) -> torch.Tensor:
        _check_epoch(ds, epoch)
        xs = ds._pod_epoch(epoch)[0] if ds._materialize else None
        losses = torch.empty(full, dtype=torch.float32, device=ds.device)
        for i in range(full):
            rows = xs[i] if xs is not None else ds._exchange(epoch, i, 1, 0)[0][0]
            losses[i] = step(*ds._unpack(rows))["loss"]
        ds.stats.batches_staged += full
        return losses

    return run_epoch


class _CapturedPodEpoch:
    """A pod's fused epoch on CUDA (:func:`make_fused_epoch`): two graphs a
    step, the gradient all-reduce between them on the host."""

    def __init__(self, ds: DeviceResidentShufflingDataset, step: Callable, full: int):
        model, optimizer, group = step.model, step.optimizer, step.group
        if not all(g.get("capturable") for g in optimizer.param_groups):
            raise ValueError("make_fused_epoch: the optimizer must be made with capturable=True")
        self._params = [p for p in model.parameters() if p.requires_grad]
        if {p.dtype for p in self._params} != {torch.float32}:
            raise TypeError("make_fused_epoch over a pod: the gradients travel in one float32 buffer, so every "
                            "trained parameter must be float32")
        dev = ds.device
        self._ds, self._model, self._optimizer, self._group, self._full = ds, model, optimizer, group, full
        self._world = dist.get_world_size(group)
        # The gradients, then the loss: one all-reduce a step.
        self._flat = torch.zeros(sum(p.numel() for p in self._params) + 1, dtype=torch.float32, device=dev)
        self._counter = torch.zeros(1, dtype=torch.int64, device=dev)
        self._losses = torch.zeros(full, dtype=torch.float32, device=dev)
        shape = (len(ds._columns), ds._shard_width(ds.batch_size))
        # The materialized epoch in the scan layout, refilled by each run's
        # exchange; or the batch that each step's exchange fills.
        self._xs = torch.zeros((full, *shape), dtype=torch.int32, device=dev) if ds._materialize else None
        self._batch = None if ds._materialize else torch.zeros((1, *shape), dtype=torch.int32, device=dev)
        self._graphs = self._capture() if full else None

    def _forward_backward(self) -> None:
        rows = self._batch[0] if self._xs is None else self._xs.index_select(0, self._counter)[0]
        features, label = self._ds._unpack(rows)
        self._optimizer.zero_grad(set_to_none=True)
        loss = bce_loss(self._model(features), label)
        loss.backward()
        torch.cat([*(p.grad.reshape(-1) for p in self._params), loss.detach().float().reshape(1)], out=self._flat)

    def _update(self) -> None:
        mean = self._flat / self._world
        at = 0
        for p in self._params:
            p.grad.copy_(mean[at : at + p.numel()].view_as(p))
            at += p.numel()
        self._optimizer.step()
        self._losses.index_copy_(0, self._counter, mean[-1:])
        self._counter.add_(1)

    def _capture(self) -> Tuple[torch.cuda.CUDAGraph, torch.cuda.CUDAGraph]:
        """Warm up (this rank alone: no all-reduce), put the model and the
        optimizer back, capture both halves. As in :class:`_CapturedEpoch`,
        the warm-up reads the zero inputs and its updates are undone."""
        opt = self._optimizer
        params = [p for group in opt.param_groups for p in group["params"]]
        with torch.no_grad():
            saved_params = [p.detach().clone() for p in params]
            saved_state = {p: {k: v.clone() for k, v in opt.state[p].items()} for p in params if opt.state.get(p)}
        dev = self._ds.device
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(FUSED_WARMUP_STEPS):
                self._counter.zero_()
                self._forward_backward()
                self._update()
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
        graphs = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[0]):
            self._forward_backward()
        with torch.cuda.graph(graphs[1]):
            self._update()
        return graphs

    def run(self, epoch: int) -> torch.Tensor:
        ds = self._ds
        _check_epoch(ds, epoch)
        if self._flat is None:
            raise RuntimeError("fused epoch released (its dataset was closed)")
        if self._xs is not None:
            ds._epoch_buf_cache.clear()  # one epoch copy at a time
            ds._exchange(epoch, 0, self._full, 0, out=self._xs)
        self._counter.zero_()
        for i in range(self._full):
            if self._batch is not None:
                ds._exchange(epoch, i, 1, 0, out=self._batch)
            self._graphs[0].replay()
            collectives.all_reduce_(self._flat, self._group)
            self._graphs[1].replay()
        ds.stats.batches_staged += self._full
        return self._losses[: self._full].clone()

    def release(self) -> None:
        self._graphs = self._flat = self._xs = self._batch = None
