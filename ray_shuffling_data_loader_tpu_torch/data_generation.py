"""Synthetic Parquet training data: the DLRM-like ``DATA_SPEC`` schema.

A copy of the JAX package's generator with the same seeds, so the files it
writes hold the same tables: 17 int64 embedding-index columns, 2 int64
one-hot columns, a float64 ``labels`` column and a ``key`` row-id column
(what the exactly-once checks read), snappy-compressed, with controllable
row groups. Files are written on the runtime's task pool. Local paths only.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from ray_shuffling_data_loader_tpu_torch import runtime

# column name -> (low, high, dtype)
DATA_SPEC = {
    "embeddings_name0": (0, 2385, np.int64),
    "embeddings_name1": (0, 201, np.int64),
    "embeddings_name2": (0, 201, np.int64),
    "embeddings_name3": (0, 6, np.int64),
    "embeddings_name4": (0, 19, np.int64),
    "embeddings_name5": (0, 1441, np.int64),
    "embeddings_name6": (0, 201, np.int64),
    "embeddings_name7": (0, 22, np.int64),
    "embeddings_name8": (0, 156, np.int64),
    "embeddings_name9": (0, 1216, np.int64),
    "embeddings_name10": (0, 9216, np.int64),
    "embeddings_name11": (0, 88999, np.int64),
    "embeddings_name12": (0, 941792, np.int64),
    "embeddings_name13": (0, 9405, np.int64),
    "embeddings_name14": (0, 83332, np.int64),
    "embeddings_name15": (0, 828767, np.int64),
    "embeddings_name16": (0, 945195, np.int64),
    "one_hot0": (0, 3, np.int64),
    "one_hot1": (0, 50, np.int64),
    "labels": (0, 1, np.float64),
}

EMBEDDING_COLUMNS = [c for c in DATA_SPEC if c.startswith("embeddings_")]
LABEL_COLUMN = "labels"
KEY_COLUMN = "key"


def generate_row_group(
    group_index: int, global_row_index: int, num_rows_in_group: int, seed: int = 0
) -> Dict[str, np.ndarray]:
    """One row group as a dict of numpy columns."""
    rng = np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(group_index, global_row_index))
    )
    buffer: Dict[str, np.ndarray] = {
        KEY_COLUMN: np.arange(
            global_row_index, global_row_index + num_rows_in_group, dtype=np.int64
        )
    }
    for col, (low, high, dtype) in DATA_SPEC.items():
        if np.issubdtype(dtype, np.integer):
            buffer[col] = rng.integers(low, high, num_rows_in_group, dtype=dtype)
        else:
            buffer[col] = (high - low) * rng.random(
                num_rows_in_group, dtype=np.float64
            ) + low
    return buffer


def row_group_sizes(
    num_rows_in_file: int,
    num_row_groups_per_file: int,
    max_row_group_skew: float,
    file_index: int,
    seed: int,
) -> List[int]:
    """Row counts per group within one file.

    ``max_row_group_skew == 0`` splits uniformly. ``0 < skew <= 1`` draws
    each group a relative weight from ``[1 - skew, 1 + skew]``, seeded by
    ``(seed, file_index)``, and scales the weights to sum exactly to
    ``num_rows_in_file``."""
    if not 0.0 <= max_row_group_skew <= 1.0:
        raise ValueError(
            f"max_row_group_skew must be in [0, 1], got {max_row_group_skew}"
        )
    group_size = max(1, num_rows_in_file // num_row_groups_per_file)
    if max_row_group_skew == 0.0:
        return [
            min(group_size, num_rows_in_file - at)
            for at in range(0, num_rows_in_file, group_size)
        ]
    num_groups = max(1, min(num_row_groups_per_file, num_rows_in_file))
    rng = np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(3, file_index))
    )
    weights = 1.0 + max_row_group_skew * rng.uniform(-1.0, 1.0, num_groups)
    weights = np.clip(weights, 1e-3, None)
    sizes = np.maximum(
        1, np.floor(weights / weights.sum() * num_rows_in_file)
    ).astype(int)
    while sizes.sum() > num_rows_in_file:
        sizes[int(np.argmax(sizes))] -= 1
    sizes[int(np.argmax(sizes))] += num_rows_in_file - sizes.sum()
    return [int(x) for x in sizes if x > 0]


def generate_file(
    file_index: int,
    global_row_index: int,
    num_rows_in_file: int,
    num_row_groups_per_file: int,
    data_dir: str,
    seed: int = 0,
    max_row_group_skew: float = 0.0,
) -> Tuple[str, int]:
    """Write one Parquet file. Returns ``(filename, in-memory bytes)``."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    sizes = row_group_sizes(
        num_rows_in_file, num_row_groups_per_file, max_row_group_skew,
        file_index, seed,
    )
    group_size = max(1, num_rows_in_file // num_row_groups_per_file)
    groups = []
    at = 0
    for group_index, n in enumerate(sizes):
        groups.append(generate_row_group(group_index, global_row_index + at, n, seed))
        at += n
    columns = {name: np.concatenate([g[name] for g in groups]) for name in groups[0]}
    data_size = sum(v.nbytes for v in columns.values())
    table = pa.table({k: pa.array(v) for k, v in columns.items()})
    filename = os.path.join(data_dir, f"input_data_{file_index}.parquet.snappy")
    if max_row_group_skew == 0.0:
        pq.write_table(table, filename, compression="snappy", row_group_size=group_size)
    else:
        with pq.ParquetWriter(filename, table.schema, compression="snappy") as writer:
            at = 0
            for n in sizes:
                writer.write_table(table.slice(at, n), row_group_size=n)
                at += n
    return filename, data_size


def generate_data(
    num_rows: int,
    num_files: int,
    num_row_groups_per_file: int,
    max_row_group_skew: float,
    data_dir: str,
    seed: int = 0,
) -> Tuple[List[str], int]:
    """Write the synthetic dataset, one pool task per file. Returns
    ``(filenames, in-memory bytes)``."""
    ctx = runtime.ensure_initialized()
    os.makedirs(data_dir, exist_ok=True)
    rows_per_file = max(1, num_rows // num_files)
    futures = [
        ctx.pool.submit(
            generate_file,
            file_index,
            global_row_index,
            min(rows_per_file, num_rows - global_row_index),
            num_row_groups_per_file,
            data_dir,
            seed,
            max_row_group_skew,
        )
        for file_index, global_row_index in enumerate(
            range(0, num_rows, rows_per_file)
        )
    ]
    filenames, data_sizes = zip(*[f.result() for f in futures])
    return list(filenames), int(sum(data_sizes))
