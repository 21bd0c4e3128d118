"""ray_tpu_torch.data: streaming datasets on numpy blocks, landing batches
on the card (counterpart of ``ray_tpu.data``).

Read API parity target: ``python/ray/data/read_api.py`` (``range``,
``from_items``, ``read_numpy`` etc.); Dataset API: ``dataset.py``.  The
reference's Arrow blocks are numpy column dicts here, so nothing of this
package needs pyarrow or pandas; the Parquet, CSV and JSON readers,
``from_arrow``/``from_pandas`` and the aggregations wait.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np

from ray_tpu_torch.data import datasource as DS
from ray_tpu_torch.data import logical as L
from ray_tpu_torch.data.block import Block, BlockMetadata, batch_to_block
from ray_tpu_torch.data.context import DataContext, ExecutionOptions
from ray_tpu_torch.data.dataset import (
    Dataset,
    MaterializedDataset,
    StreamingSplit,
)
from ray_tpu_torch.data.iterator import DataIterator, IngestStats
from ray_tpu_torch.data.operators import ActorPoolStrategy

__all__ = [
    "ActorPoolStrategy", "BlockMetadata", "DataContext", "DataIterator",
    "Dataset", "ExecutionOptions", "IngestStats",
    "MaterializedDataset", "StreamingSplit", "from_blocks", "from_items",
    "from_numpy", "range", "read_binary_files", "read_datasource",
    "read_numpy", "read_text",
]


def read_datasource(ds: DS.Datasource, *, parallelism: int = -1) -> Dataset:
    return Dataset(L.LogicalPlan(L.Read(ds, parallelism)))


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001
    return read_datasource(DS.RangeDatasource(n), parallelism=parallelism)


def from_items(items: List[Any], *, parallelism: int = -1) -> Dataset:
    return read_datasource(DS.ItemsDatasource(items), parallelism=parallelism)


def from_numpy(arr, column: str = "data") -> Dataset:
    """One block whose column ``column`` is ``arr`` (rows along its first
    dimension; an n-d array is a tensor column)."""
    return from_blocks([batch_to_block({column: np.asarray(arr)})])


def from_blocks(blocks: List[Block]) -> Dataset:
    """A dataset of the given blocks (numpy column dicts), one read task
    each."""
    blocks = [batch_to_block(b) for b in blocks]
    return read_datasource(DS.BlocksDatasource(blocks),
                           parallelism=len(blocks) or 1)


def read_text(paths, *, parallelism: int = -1) -> Dataset:
    return read_datasource(DS.TextDatasource(paths), parallelism=parallelism)


def read_numpy(paths, *, parallelism: int = -1) -> Dataset:
    return read_datasource(DS.NumpyDatasource(paths), parallelism=parallelism)


def read_binary_files(paths, *, parallelism: int = -1) -> Dataset:
    return read_datasource(DS.BinaryDatasource(paths), parallelism=parallelism)
