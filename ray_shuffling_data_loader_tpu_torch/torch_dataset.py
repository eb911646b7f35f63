"""The Torch adapter: shuffled batches as ``(features, label)`` CPU tensors.

A copy of the JAX package's adapter over this package's
:class:`~.dataset.ShufflingDataset`: an ``IterableDataset`` whose batches
a column spec turns into tensors (feature columns with their shapes and
dtypes, and a label column). The tensors live on the CPU, as the
reference's do; :class:`~.device_dataset.DeviceShufflingDataset` stages
batches to the GPU instead.

The spec is a pair of dataclasses (:class:`ColumnSpec` per column,
:class:`TensorBatchSpec` for the batch). The converter takes a
:class:`~.runtime.ColumnBatch` (numpy columns) or a DataFrame; columns of
ndarrays, lists or tuples are stacked.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.data import IterableDataset

from ray_shuffling_data_loader_tpu_torch.batch_queue import DEFAULT_QUEUE_NAME
from ray_shuffling_data_loader_tpu_torch.dataset import ShufflingDataset


@dataclass(frozen=True)
class ColumnSpec:
    """One output tensor: source column, dtype and row shape.

    ``shape=None`` means a trailing unit dimension (``[batch, 1]``)."""

    name: Any
    dtype: torch.dtype = torch.float
    shape: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if not isinstance(self.dtype, torch.dtype):
            raise ValueError(f"column {self.name!r}: dtype must be a torch.dtype, got {self.dtype!r}")

    def to_tensor(self, values: np.ndarray) -> torch.Tensor:
        t = torch.as_tensor(values, dtype=self.dtype)
        if self.shape is not None:
            return t.view(-1, *self.shape)
        return t.view(-1, 1)


@dataclass(frozen=True)
class TensorBatchSpec:
    """The whole batch: feature columns and one label column."""

    features: Tuple[ColumnSpec, ...]
    label: ColumnSpec

    @classmethod
    def build(
        cls,
        feature_columns,
        feature_shapes=None,
        feature_types=None,
        label_column=None,
        label_shape=None,
        label_type=None,
    ) -> "TensorBatchSpec":
        """From the reference adapter's keywords: a scalar becomes a
        one-element list, dtypes default to ``torch.float``, shapes to
        ``None`` (a unit trailing dimension)."""
        names = list(feature_columns) if isinstance(feature_columns, list) else [feature_columns]

        def _broadcast(value, what, wrap_scalar):
            if not value:
                return [None] * len(names)
            items = list(value) if isinstance(value, list) else [value]
            if len(items) != len(names):
                raise ValueError(f"{what} has {len(items)} entries for {len(names)} feature_columns")
            return [wrap_scalar(v) for v in items]

        shapes = _broadcast(
            feature_shapes,
            "feature_shapes",
            # None inside the list: this column keeps the (-1, 1) view.
            lambda s: None if s is None else tuple(s) if isinstance(s, Iterable) else (s,),
        )
        dtypes = _broadcast(feature_types, "feature_types", lambda d: d)
        features = tuple(
            ColumnSpec(name=n, dtype=d if d is not None else torch.float, shape=s)
            for n, s, d in zip(names, shapes, dtypes)
        )
        label = ColumnSpec(
            name=label_column,
            dtype=label_type if label_type else torch.float,
            shape=(label_shape,) if label_shape else None,
        )
        return cls(features=features, label=label)

    def __call__(self, batch) -> Tuple[List[torch.Tensor], torch.Tensor]:
        feature_tensors = [spec.to_tensor(_column_values(batch, spec.name)) for spec in self.features]
        label = self.label.to_tensor(_column_values(batch, self.label.name))
        return feature_tensors, label


class TorchShufflingDataset(IterableDataset):
    """A shuffling dataset yielding ``(feature_tensors, label_tensor)``
    batches of CPU tensors.

    Arguments as :class:`~.dataset.ShufflingDataset`, plus the tensor spec:
    ``feature_columns``, optional ``feature_shapes`` and ``feature_types``,
    ``label_column``, optional ``label_shape`` and ``label_type``.
    ``narrow_to_32`` is off by default, so that dtypes are those of the
    files until the spec's types apply.
    """

    def __init__(
        self,
        filenames: List[str],
        num_epochs: int,
        num_trainers: int,
        batch_size: int,
        rank: int,
        drop_last: bool = False,
        num_reducers: Optional[int] = None,
        max_concurrent_epochs: int = 2,
        seed: int = 0,
        queue_name: str = DEFAULT_QUEUE_NAME,
        feature_columns: List[Any] = None,
        feature_shapes: Optional[List[Any]] = None,
        feature_types: Optional[List[torch.dtype]] = None,
        label_column: Any = None,
        label_shape: Optional[int] = None,
        label_type: Optional[torch.dtype] = None,
        narrow_to_32: bool = False,
        cache_decoded: Optional[bool] = None,
    ):
        super().__init__()
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
            narrow_to_32=narrow_to_32,
            cache_decoded=cache_decoded,
        )
        self._spec = TensorBatchSpec.build(
            feature_columns=feature_columns,
            feature_shapes=feature_shapes,
            feature_types=feature_types,
            label_column=label_column,
            label_shape=label_shape,
            label_type=label_type,
        )

    def set_epoch(self, epoch: int) -> None:
        """Call before each epoch's iteration."""
        self._ds.set_epoch(epoch)

    def __iter__(self):
        for batch in iter(self._ds):
            yield self._spec(batch)


def batch_to_tensor_factory(
    feature_columns: List[Any] = None,
    feature_shapes: Optional[List[Any]] = None,
    feature_types: Optional[List[torch.dtype]] = None,
    label_column: Any = None,
    label_shape: Optional[int] = None,
    label_type: Optional[torch.dtype] = None,
) -> TensorBatchSpec:
    """The batch -> ``(feature_tensors, label_tensor)`` converter (the
    spec is callable)."""
    return TensorBatchSpec.build(
        feature_columns=feature_columns,
        feature_shapes=feature_shapes,
        feature_types=feature_types,
        label_column=label_column,
        label_shape=label_shape,
        label_type=label_type,
    )


# The reference adapter's name.
dataframe_to_tensor_factory = batch_to_tensor_factory


def _column_values(batch, col) -> np.ndarray:
    values = np.asarray(batch[col])
    if not values.flags.writeable:
        # Store columns are read-only views of a mapped segment; a tensor
        # must own writable memory, or an in-place op would fault.
        values = values.copy()
    if values.dtype == object:
        first = values[0]
        if isinstance(first, np.ndarray):
            values = np.stack(values)
        elif isinstance(first, (list, tuple)):
            values = np.asarray([np.asarray(v) for v in values])
        else:
            raise TypeError(
                f"column {col!r} holds {type(first).__name__} objects, "
                "which is not supported: object columns must contain "
                "ndarray, list, or tuple rows"
            )
    return values


def convert_to_tensor(
    batch,
    feature_columns: List[Any],
    feature_shapes: List[Any],
    feature_types: List[torch.dtype],
    label_column: Any,
    label_shape: Optional[int],
    label_type: torch.dtype,
):
    """The conversion in one call, for callers that hold plain lists; takes
    a ColumnBatch or a DataFrame."""
    spec = TensorBatchSpec.build(
        feature_columns=feature_columns,
        feature_shapes=feature_shapes,
        feature_types=feature_types,
        label_column=label_column,
        label_shape=label_shape,
        label_type=label_type,
    )
    return spec(batch)
