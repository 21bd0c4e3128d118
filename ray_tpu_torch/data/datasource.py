"""Datasources: pluggable readers producing ReadTasks (counterpart of
``ray_tpu/data/datasource.py``).

Reference: ``python/ray/data/datasource/datasource.py`` (``Datasource``,
``ReadTask``) and the per-format datasources under
``python/ray/data/_internal/datasource/``.  A ``ReadTask`` is a zero-arg
callable returning an iterator of output blocks, plus metadata estimated
*before* execution so the optimizer can plan parallelism.

Ported: ranges, items, in-memory blocks, ``.npy`` files, binary files
and text files, all as numpy blocks.  The Parquet, CSV and JSON readers
and the file datasinks need pyarrow (or numpy-native readers) and wait.
"""

from __future__ import annotations

import glob as globlib
import os
from typing import Any, Callable, Iterator, List, Optional

import numpy as np

from ray_tpu_torch.data.block import (
    Block,
    BlockMetadata,
    batch_to_block,
    rows_to_block,
)


class ReadTask:
    def __init__(self, read_fn: Callable[[], Iterator[Block]],
                 metadata: BlockMetadata):
        self._read_fn = read_fn
        self.metadata = metadata

    def __call__(self) -> Iterator[Block]:
        return self._read_fn()


class Datasource:
    """ABC: estimate size, then produce up to ``parallelism`` ReadTasks."""

    def estimate_inmemory_data_size(self) -> Optional[int]:
        return None

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__.replace("Datasource", "")


class RangeDatasource(Datasource):
    def __init__(self, n: int):
        self._n = n

    def estimate_inmemory_data_size(self) -> int:
        return self._n * 8

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        parallelism = max(1, min(parallelism, self._n or 1))
        tasks = []
        per = -(-self._n // parallelism) if self._n else 0
        for i in range(parallelism):
            start, end = i * per, min((i + 1) * per, self._n)
            if start >= end and self._n > 0:
                break

            def make(start=start, end=end):
                def read() -> Iterator[Block]:
                    yield {"id": np.arange(start, end, dtype=np.int64)}

                return read

            tasks.append(ReadTask(make(), BlockMetadata(
                num_rows=end - start, size_bytes=(end - start) * 8,
                schema={"id": (np.dtype(np.int64), ())})))
        return tasks


class ItemsDatasource(Datasource):
    def __init__(self, items: List[Any]):
        self._items = list(items)

    def estimate_inmemory_data_size(self) -> int:
        return len(self._items) * 64

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        n = len(self._items)
        parallelism = max(1, min(parallelism, n or 1))
        per = -(-n // parallelism) if n else 0
        tasks = []
        for i in range(parallelism):
            chunk = self._items[i * per:(i + 1) * per]
            if not chunk and n > 0:
                break

            def make(chunk=chunk):
                def read() -> Iterator[Block]:
                    yield rows_to_block(chunk)

                return read

            tasks.append(ReadTask(make(), BlockMetadata(
                num_rows=len(chunk), size_bytes=len(chunk) * 64)))
        return tasks


class BlocksDatasource(Datasource):
    """In-memory blocks (from_numpy / from_blocks)."""

    def __init__(self, blocks: List[Block]):
        self._blocks = blocks

    def estimate_inmemory_data_size(self) -> int:
        return sum(BlockMetadata.for_block(b).size_bytes for b in self._blocks)

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        tasks = []
        for b in self._blocks:
            def make(b=b):
                def read() -> Iterator[Block]:
                    yield b

                return read

            tasks.append(ReadTask(make(), BlockMetadata.for_block(b)))
        return tasks


def _expand_paths(paths, suffix: Optional[str]) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            pat = os.path.join(p, "**", f"*{suffix}" if suffix else "*")
            out.extend(sorted(f for f in globlib.glob(pat, recursive=True)
                              if os.path.isfile(f)))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(globlib.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"No input files found for {paths!r}")
    return out


class FileBasedDatasource(Datasource):
    """One ReadTask per group of files, grouped to meet the parallelism."""

    _suffix: Optional[str] = None

    def __init__(self, paths):
        self._paths = _expand_paths(paths, self._suffix)

    def estimate_inmemory_data_size(self) -> int:
        return sum(os.path.getsize(p) for p in self._paths)

    def _read_file(self, path: str) -> Iterator[Block]:
        raise NotImplementedError

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        groups: List[List[str]] = [[] for _ in range(min(parallelism, len(self._paths)))]
        for i, p in enumerate(self._paths):
            groups[i % len(groups)].append(p)
        tasks = []
        for group in groups:
            def make(group=group, self=self):
                def read() -> Iterator[Block]:
                    for path in group:
                        yield from self._read_file(path)

                return read

            tasks.append(ReadTask(make(), BlockMetadata(
                num_rows=0, size_bytes=sum(os.path.getsize(p) for p in group),
                input_files=group)))
        return tasks


class TextDatasource(FileBasedDatasource):
    def _read_file(self, path: str) -> Iterator[Block]:
        with open(path, "r") as f:
            lines = [ln.rstrip("\n") for ln in f]
        yield {"text": np.array(lines, dtype=object)}


class BinaryDatasource(FileBasedDatasource):
    def _read_file(self, path: str) -> Iterator[Block]:
        with open(path, "rb") as f:
            data = f.read()
        yield rows_to_block([{"bytes": data, "path": path}])


class NumpyDatasource(FileBasedDatasource):
    _suffix = ".npy"

    def _read_file(self, path: str) -> Iterator[Block]:
        yield batch_to_block({"data": np.load(path)})
