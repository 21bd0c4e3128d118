"""Blocks of the data plane: numpy column dicts (counterpart of
``ray_tpu/data/block.py``).

A *block* is the unit of data movement and parallelism: a horizontal
slice of a dataset, processed by one task.  The reference's blocks are
Arrow tables; the port's are ``Dict[str, np.ndarray]`` whose arrays share
their first dimension (the rows), so that nothing here needs pyarrow or
pandas.  A tensor column is simply an n-d array, so the reference's
tensor-shape marker has no counterpart.  String columns are object
arrays of ``str``, as the reference's Arrow strings convert to numpy.

``BlockMetadata`` travels beside the block, so the streaming executor can
schedule without touching data.  ``schema`` is ``{name: (dtype,
shape[1:])}``; ``exec_node_id`` stays for the reference's locality
routing and is ``None``: the port runs on one node.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

Block = Dict[str, np.ndarray]
# A batch handed to user fns in map_batches: a dict of column -> numpy
# array (the "numpy" and "default" formats; the reference's pandas and
# pyarrow formats wait for a numpy-native reader).
Batch = Dict[str, np.ndarray]
Schema = Dict[str, Tuple[np.dtype, Tuple[int, ...]]]


def num_rows(block: Block) -> int:
    for col in block.values():
        return len(col)
    return 0


def _objects(values: List[Any]) -> np.ndarray:
    col = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        col[i] = v
    return col


def _column(values: Any) -> np.ndarray:
    """One column as an array: sequences of equal-shaped values stack into
    an n-d array, ragged ones become an object array, and strings and
    bytes become objects (as Arrow's do in the reference; numpy's fixed
    width bytes would drop trailing zero bytes)."""
    if isinstance(values, np.ndarray):
        col = values
    else:
        if not isinstance(values, (list, tuple)):
            values = list(values)
        if values and isinstance(values[0], (str, bytes)):
            return _objects(values)
        try:
            col = np.asarray(values)
        except ValueError:  # ragged: one object per row
            col = _objects(values)
    if col.ndim == 0:
        raise ValueError("a block column must have one entry per row")
    if col.dtype.kind in "US":
        col = col.astype(object)
    return col


@dataclass
class BlockMetadata:
    """Out-of-band stats for one block (reference ``block.py:BlockMetadata``)."""

    num_rows: int
    size_bytes: int
    schema: Optional[Schema] = None
    input_files: List[str] = field(default_factory=list)
    exec_stats: Optional[Dict[str, float]] = None
    exec_node_id: Optional[str] = None

    @staticmethod
    def for_block(block: Block, input_files: Optional[List[str]] = None,
                  start_time: Optional[float] = None) -> "BlockMetadata":
        stats = None
        if start_time is not None:
            stats = {"wall_s": time.perf_counter() - start_time}
        acc = BlockAccessor(block)
        return BlockMetadata(
            num_rows=acc.num_rows(),
            size_bytes=acc.size_bytes(),
            schema=acc.schema(),
            input_files=list(input_files or []),
            exec_stats=stats,
        )


def batch_to_block(batch: Batch) -> Block:
    """Convert a user-returned batch (a dict of columns) into a block."""
    if not isinstance(batch, dict):
        raise TypeError(
            f"Batch must be dict[str, np.ndarray] (the port's blocks are "
            f"numpy column dicts); got {type(batch)}")
    block = {str(name): _column(col) for name, col in batch.items()}
    lengths = {name: len(col) for name, col in block.items()}
    if len(set(lengths.values())) > 1:
        raise ValueError(f"batch columns differ in length: {lengths}")
    return block


def rows_to_block(rows: List[Any]) -> Block:
    """Build a block from a list of row dicts (wrapping plain items as
    ``{'item': x}``).  The columns are the first row's keys, as Arrow's
    ``from_pylist`` infers them; a missing value is ``None``."""
    norm = [r if isinstance(r, dict) else {"item": r} for r in rows]
    if not norm:
        return {}
    return {name: _column([r.get(name) for r in norm]) for name in norm[0]}


def concat_blocks(blocks: List[Block]) -> Block:
    """Concatenate blocks by rows; a column missing from a block is filled
    with ``None`` (the reference's default schema promotion)."""
    blocks = [b for b in blocks if b is not None and num_rows(b) > 0]
    if not blocks:
        return {}
    if len(blocks) == 1:
        return blocks[0]
    names: List[str] = []
    for b in blocks:
        names.extend(n for n in b if n not in names)
    out: Block = {}
    for name in names:
        parts = []
        for b in blocks:
            if name in b:
                parts.append(b[name])
            else:
                parts.append(np.full(num_rows(b), None, dtype=object))
        out[name] = np.concatenate(parts)
    return out


def _read_only(col: np.ndarray) -> np.ndarray:
    view = col.view()
    view.flags.writeable = False
    return view


class BlockAccessor:
    """Uniform view over a block (reference ``BlockAccessor``)."""

    def __init__(self, block: Block):
        self._block = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    def num_rows(self) -> int:
        return num_rows(self._block)

    def size_bytes(self) -> int:
        return int(sum(col.nbytes for col in self._block.values()))

    def schema(self) -> Schema:
        return {name: (col.dtype, col.shape[1:])
                for name, col in self._block.items()}

    def to_numpy(self, columns: Optional[List[str]] = None) -> Batch:
        """The columns as read-only views: a batch handed to user code
        cannot write through to the block (the reference's Arrow-backed
        arrays are read-only alike)."""
        cols = columns or list(self._block)
        return {name: _read_only(self._block[name]) for name in cols}

    def to_batch(self, batch_format: str = "numpy") -> Batch:
        if batch_format in ("numpy", "default"):
            return self.to_numpy()
        if batch_format in ("pandas", "pyarrow", "arrow"):
            raise ValueError(
                f"batch_format {batch_format!r} needs pandas or pyarrow, "
                "which the port does not use; its batches are numpy")
        raise ValueError(f"Unknown batch_format: {batch_format!r}")

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        """Rows as dicts: numpy values when a column is a tensor column,
        else Python values (the reference's ``to_pylist`` rows)."""
        n = self.num_rows()
        if any(col.ndim > 1 for col in self._block.values()):
            for i in range(n):
                yield {k: v[i] for k, v in self._block.items()}
            return
        cols = {k: v.tolist() for k, v in self._block.items()}
        for i in range(n):
            yield {k: v[i] for k, v in cols.items()}

    def slice(self, start: int, end: int) -> Block:
        return {k: v[start:end] for k, v in self._block.items()}

    def take_rows(self, indices: np.ndarray) -> Block:
        idx = np.asarray(indices, dtype=np.int64)
        return {k: v[idx] for k, v in self._block.items()}

    def select(self, columns: List[str]) -> Block:
        return {k: self._block[k] for k in columns}

    def sample(self, n: int, seed: Optional[int] = None) -> Block:
        rng = np.random.default_rng(seed)
        n = min(n, self.num_rows())
        idx = rng.choice(self.num_rows(), size=n, replace=False)
        return self.take_rows(idx)


class BlockBuilder:
    """Accumulate rows/batches/blocks up to a target size, then yield blocks."""

    def __init__(self, target_max_block_size: Optional[int] = None):
        self._rows: List[Dict[str, Any]] = []
        self._blocks: List[Block] = []
        self._approx_bytes = 0
        self._target = target_max_block_size

    def add_row(self, row: Dict[str, Any]):
        self._rows.append(row if isinstance(row, dict) else {"item": row})
        self._approx_bytes += 64  # cheap estimate; refined on build

    def add_batch(self, batch: Batch):
        self.add_block(batch_to_block(batch))

    def add_block(self, block: Block):
        if num_rows(block):
            self._blocks.append(block)
            self._approx_bytes += BlockAccessor(block).size_bytes()

    def num_rows(self) -> int:
        return len(self._rows) + sum(num_rows(b) for b in self._blocks)

    def current_size_bytes(self) -> int:
        return self._approx_bytes

    def should_flush(self) -> bool:
        return self._target is not None and self._approx_bytes >= self._target

    def build(self) -> Block:
        blocks = list(self._blocks)
        if self._rows:
            blocks.append(rows_to_block(self._rows))
        self._rows, self._blocks, self._approx_bytes = [], [], 0
        return concat_blocks(blocks)
