"""Port parity: ``ray_tpu_torch.data`` (numpy blocks, thread tasks, the
device-landing iterator) against ``ray_tpu.data`` on the shared CPU
cluster.

Every case makes the same pipeline in both packages with one function
(the two share their API) and compares rows, batches and dtypes exactly;
a multiset comparison is used only where the reference itself gives
other rows from run to run.  The reference's functions travel to its
workers by value, so the case functions use lambdas and local classes
only.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu.data as jd
import ray_tpu_torch.data as td
from ray_tpu_torch.data import _tasks
from ray_tpu_torch.data.context import DataContext

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _value(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v


def _rows(ds):
    return [{k: _value(v) for k, v in r.items()} for r in ds.take_all()]


def _batches(it):
    return [{k: np.asarray(v).tolist() for k, v in b.items()} for b in it]


def _multiset(rows):
    return sorted(repr(sorted(r.items())) for r in rows)


def _actor_pool(rd):
    class AddState:
        def __init__(self):
            self.offset = 100

        def __call__(self, batch):
            return {"id": batch["id"] + self.offset}

    return rd.range(40, parallelism=4).map_batches(
        AddState, compute=rd.ActorPoolStrategy(size=2))


def _img(rd):
    arr = np.random.default_rng(0).standard_normal((6, 2, 3)).astype(
        np.float32)
    return rd.from_numpy(arr, column="img")


def _items(rd):
    return rd.from_items([{"a": i, "b": f"s{i}", "c": i / 4}
                          for i in range(10)], parallelism=3)


# one function per case, applied to both packages
CASES = {
    "range": lambda rd: rd.range(20, parallelism=4),
    "from_items": _items,
    "from_items_plain": lambda rd: rd.from_items(list(range(7))),
    "from_numpy_3d": _img,
    "map": lambda rd: rd.range(10).map(lambda r: {"x": r["id"] ** 2}),
    "map_batches": lambda rd: rd.range(50).map_batches(
        lambda b: {"id": b["id"] + 1}).map_batches(
        lambda b: {"id": b["id"] * 2, "f": b["id"].astype(np.float32) / 3}),
    "map_batches_batch_size": lambda rd: rd.range(23, parallelism=2)
    .map_batches(lambda b: {"id": b["id"], "n": np.full(len(b["id"]),
                                                         len(b["id"]))},
                 batch_size=4),
    "map_batches_3d": lambda rd: _img(rd).map_batches(
        lambda b: {"img": b["img"] * 2, "s": b["img"].sum(axis=(1, 2))}),
    "map_batches_actor_pool": _actor_pool,
    "filter": lambda rd: rd.range(30, parallelism=3).filter(
        lambda r: r["id"] % 3 == 1),
    "flat_map": lambda rd: rd.range(6).flat_map(
        lambda r: [r, {"id": r["id"] + 100}]),
    "limit": lambda rd: rd.range(1000, parallelism=10).limit(25),
    "repartition": lambda rd: rd.range(100, parallelism=10).repartition(3),
    "union": lambda rd: rd.range(5).union(
        rd.range(5).map(lambda r: {"id": r["id"] + 5})),
    "zip": lambda rd: rd.range(6, parallelism=2).zip(
        rd.range(6, parallelism=3).map(lambda r: {"y": r["id"] * 10})),
    "random_shuffle": lambda rd: rd.range(50, parallelism=5)
    .random_shuffle(seed=3),
    "randomize_block_order": lambda rd: rd.range(40, parallelism=8)
    .randomize_block_order(seed=5),
    "random_sample": lambda rd: rd.range(200, parallelism=4)
    .random_sample(0.3, seed=11),
    "select_columns": lambda rd: _items(rd).select_columns(["a", "c"]),
    "drop_columns": lambda rd: _items(rd).drop_columns(["b"]),
    "add_column": lambda rd: _items(rd).add_column(
        "d", lambda b: b["a"] * 10),
    "rename_columns": lambda rd: _items(rd).rename_columns({"a": "a2"}),
}


# the union emits its inputs' bundles, and the zip its blocks, as they
# arrive: in the reference too, whose order differs from run to run
MULTISET_CASES = {"union", "zip"}


@pytest.mark.parametrize("case", list(CASES))
def test_rows_parity(ray_start, case):
    """take_all row for row (and the first batch's dtypes) against the
    reference."""
    want, got = CASES[case](jd), CASES[case](td)
    if case in MULTISET_CASES:
        assert _multiset(_rows(got)) == _multiset(_rows(want))
    else:
        assert _rows(got) == _rows(want)
    wb, gb = want.take_batch(5), got.take_batch(5)
    assert {k: np.asarray(v).dtype for k, v in gb.items()} == \
        {k: np.asarray(v).dtype for k, v in wb.items()}


def test_random_shuffle_reproducible_in_reference(ray_start):
    """The shuffle case compares row for row because the reference gives
    the same rows twice for a seed; unseeded, only the multiset."""
    make = CASES["random_shuffle"]
    assert _rows(make(jd)) == _rows(make(jd))
    want = _rows(jd.range(60, parallelism=6).repartition(4, shuffle=True))
    got = _rows(td.range(60, parallelism=6).repartition(4, shuffle=True))
    assert _multiset(got) == _multiset(want)
    assert got != [{"id": i} for i in range(60)]


@pytest.mark.parametrize("case", ["range", "limit", "repartition", "union",
                                  "zip", "randomize_block_order"])
def test_block_structure_parity(ray_start, case):
    want, got = CASES[case](jd), CASES[case](td)
    assert got.num_blocks() == want.num_blocks()
    assert got.count() == want.count()


def test_schema_columns_and_size(ray_start):
    got = _items(td)
    assert got.columns() == list(_items(jd).columns())
    schema = got.schema()
    assert schema["a"] == (np.dtype(np.int64), ())
    assert schema["b"][0] == np.dtype(object)
    assert _img(td).schema()["img"] == (np.dtype(np.float32), (2, 3))
    assert td.range(10).size_bytes() == 80


def test_read_numpy(ray_start, tmp_path):
    rng = np.random.default_rng(1)
    for i in range(3):
        np.save(tmp_path / f"part{i}.npy",
                rng.integers(0, 100, (4 + i, 3)).astype(np.int32))
    want, got = jd.read_numpy(str(tmp_path)), td.read_numpy(str(tmp_path))
    assert _rows(got) == _rows(want)
    assert got.take_batch(20)["data"].dtype == np.int32


def test_read_text_and_binary(ray_start, tmp_path):
    (tmp_path / "f.txt").write_text("hello\nworld\n")
    (tmp_path / "b.bin").write_bytes(b"ab\x00\x00")
    assert _rows(td.read_text(str(tmp_path / "f.txt"))) == \
        _rows(jd.read_text(str(tmp_path / "f.txt")))
    rows = td.read_binary_files(str(tmp_path / "b.bin")).take_all()
    assert rows == [{"bytes": b"ab\x00\x00", "path": str(tmp_path / "b.bin")}]


@pytest.mark.parametrize("batch_size,drop_last", [(5, False), (5, True),
                                                  (7, True), (None, False)])
def test_iter_batches_parity(ray_start, batch_size, drop_last):
    kw = dict(batch_size=batch_size, drop_last=drop_last)
    want = _batches(jd.range(23, parallelism=3).iter_batches(**kw))
    got = _batches(td.range(23, parallelism=3).iter_batches(**kw))
    assert got == want


@pytest.mark.parametrize("prefetch", [0, 2])
def test_iter_batches_local_shuffle_parity(ray_start, prefetch):
    kw = dict(batch_size=10, local_shuffle_buffer_size=50,
              local_shuffle_seed=7, prefetch_batches=prefetch)
    want = _batches(jd.range(100, parallelism=2).iter_batches(**kw))
    got = _batches(td.range(100, parallelism=2).iter_batches(**kw))
    assert got == want
    assert [x for b in got for x in b["id"]] != list(range(100))


def _xy(rd):
    return rd.range(24, parallelism=3).map_batches(lambda b: {
        "x": np.stack([b["id"] * 0.5, b["id"] / 7.0, -b["id"] * 1.25], 1),
        "y": (b["id"] * 3 - 40).astype(np.int32)})


@pytest.mark.parametrize("prefetch", [0, 2])
def test_iter_torch_batches_vs_iter_jax_batches(ray_start, prefetch):
    want = list(_xy(jd).iter_jax_batches(
        batch_size=8, dtypes={"x": np.float32}, prefetch_batches=prefetch))
    got = list(_xy(td).iter_torch_batches(
        batch_size=8, dtypes={"x": torch.float32}, device="cpu",
        prefetch_batches=prefetch))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"x", "y"}
        for k in g:
            assert g[k].device.type == "cpu"
            assert str(g[k].dtype).removeprefix("torch.") == str(w[k].dtype)
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_three_batches_held_at_once_are_intact(prefetch, dtype):
    """The alias guard: a CPU batch is its staging buffer, so no batch
    still held is overwritten by a later one (bf16, which numpy lacks, is
    cast by torch)."""
    data = np.arange(60, dtype=np.int64).reshape(20, 3)
    it = td.from_numpy(data).iter_torch_batches(
        batch_size=4, dtypes={"data": dtype}, device="cpu",
        prefetch_batches=prefetch)
    held = [next(it) for _ in range(3)]
    rest = list(it)
    assert len(held + rest) == 5
    for i, b in enumerate(held + rest):
        want = torch.from_numpy(data[4 * i:4 * i + 4]).to(dtype)
        assert b["data"].dtype == dtype and torch.equal(b["data"], want)


@pytest.mark.parametrize("dtypes", [None, {"x": torch.float64}])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_slice_held_across_batches_is_intact(prefetch, dtypes):
    """A slice kept after its batch is dropped still reads its own rows:
    a CPU batch's buffer is never reused for a later batch."""
    data = np.arange(24, dtype=np.float32).reshape(12, 2)
    ds = td.from_numpy(data, column="x")
    rows = [b["x"][0] for b in ds.iter_torch_batches(
        batch_size=2, dtypes=dtypes, device="cpu", prefetch_batches=prefetch)]
    assert len(rows) == 6
    for i, r in enumerate(rows):
        np.testing.assert_array_equal(r.numpy(), data[2 * i])


def test_device_none_needs_cuda():
    """Without CUDA, ``device=None`` raises; the CPU is only taken when
    asked for."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None lands there")
    ds = td.range(8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(iter(ds.iter_torch_batches(batch_size=4)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ds.to_tensors()
    out = ds.to_tensors(device="cpu")
    assert out["id"].tolist() == list(range(8))


def test_to_numpy_and_to_torch(ray_start):
    want = _xy(jd).to_numpy()
    got = _xy(td).to_numpy()
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    batches = list(_xy(td).to_torch(batch_size=12, device="cpu"))
    assert [b["x"].shape[0] for b in batches] == [12, 12]


@pytest.mark.parametrize("prefetch", [0, 2])
def test_map_error_surfaces_at_its_block(prefetch):
    """Blocks 0..k-1 come out before the error of block k, however the
    tasks finish."""
    def fn(b):
        if b["id"][0] == 15:
            raise ValueError("boom at block 3")
        if b["id"][0] < 15:
            time.sleep(0.05)  # the failing block finishes first
        return b

    ds = td.range(40, parallelism=8).map_batches(fn)
    seen = []
    with pytest.raises(ValueError, match="boom at block 3"):
        for b in ds.iter_batches(batch_size=5, prefetch_batches=prefetch):
            seen.extend(b["id"].tolist())
    assert seen == list(range(15))


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name in ("rtpu-data-prefetch", "rtpu-data-lookahead")]


@pytest.mark.parametrize("method", ["iter_batches", "iter_torch_batches"])
def test_break_leaves_no_prefetch_thread(method):
    before = set(_prefetch_threads())
    ds = td.range(200, parallelism=10)
    kw = {"device": "cpu"} if method == "iter_torch_batches" else {}
    for i, _ in enumerate(getattr(ds, method)(batch_size=4,
                                              prefetch_batches=2, **kw)):
        if i == 2:
            break
    left = [t for t in _prefetch_threads() if t not in before]
    for t in left:
        t.join(timeout=10)
    assert not [t for t in left if t.is_alive()]


def test_ingest_stats():
    it = td.range(64, parallelism=4).iterator()
    n = sum(1 for _ in it.iter_torch_batches(batch_size=8, device="cpu",
                                             prefetch_batches=2))
    d = it.ingest_stats.to_dict()
    assert n == 8 and d["batches"] == 8 and d["blocks"] == 4
    assert d["bytes_fetched"] == 64 * 8
    assert d["device_buffer_capacity"] == 2
    assert d["h2d_s"] >= d["host_cast_s"] > 0
    assert "consumer blocked" in it.stats()


def _drain(split, batch_size=10):
    results = [[] for _ in split]
    errors = []

    def consume(i):
        try:
            for b in split[i].iter_batches(batch_size=batch_size,
                                           prefetch_batches=0):
                results[i].extend(b["id"].tolist())
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=consume, args=(i,))
               for i in range(len(split))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not [t for t in threads if t.is_alive()]
    return results, errors


def _segments(split):
    return [os.path.exists(f"/dev/shm/{ch.name}")
            for ch in split.coordinator.channels]


def _reference_split_counts(ds, n):
    """Each output's rows under the reference's ``OutputSplitter``, fed the
    reference's blocks in order (in-process: the reference's coordinator
    actor retires itself by ``os._exit`` on a timer, which can cut a
    later split short on the shared cluster)."""
    from ray_tpu.data.block import BlockMetadata
    from ray_tpu.data.operators import OutputSplitter, RefBundle

    splitter = OutputSplitter(None, n, equal=True)
    for bundle in ds.materialize()._bundles:
        for _, meta in bundle.blocks:
            splitter.add_input(RefBundle([(None, BlockMetadata(
                num_rows=meta.num_rows, size_bytes=meta.size_bytes))]))
    return splitter.split_stats()["rows_per_output"]


@pytest.mark.parametrize("n,blocks", [(2, 6), (3, 6), (2, 5)])
def test_streaming_split_parity(ray_start, n, blocks):
    """Ranks are disjoint, their union is the dataset, and each rank's
    count is the reference's (the splitter's fewest-rows rule)."""
    want = _reference_split_counts(jd.range(60, parallelism=blocks), n)
    split = td.range(60, parallelism=blocks).streaming_split(n, equal=True)
    got, errors = _drain(split)
    assert not errors
    assert sorted(x for r in got for x in r) == list(range(60))
    assert sum(len(r) for r in got) == 60  # disjoint
    assert [len(r) for r in got] == want
    assert split[0].ingest_stats.to_dict()["blocks"] > 0
    split.shutdown()
    assert _segments(split) == [False] * n


def test_streaming_split_segments_go_once_drained():
    split = td.range(40, parallelism=4).streaming_split(2, equal=True)
    assert _segments(split) == [True, True]
    _drain(split)
    deadline = time.monotonic() + 10
    while any(_segments(split)) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert _segments(split) == [False, False]
    assert "rows_per_output" in str(split.coordinator.split_stats())
    split.shutdown()


def test_streaming_split_error_reaches_every_rank():
    def fn(b):
        if b["id"][0] == 20:
            raise ValueError("bad block")
        return b

    split = td.range(40, parallelism=4).map_batches(fn).streaming_split(2)
    got, errors = _drain(split)
    assert len(errors) == 2
    assert all("bad block" in str(e) for e in errors)
    assert sorted(x for r in got for x in r) == list(range(20))
    split.shutdown()


def test_streaming_split_error_keeps_bundles_routed_before_it(monkeypatch):
    """An error raised in the executor step that also routed bundles to
    the ranks reaches them after those bundles, not in their place."""
    from ray_tpu_torch.data import streaming_executor as se

    step = se.StreamingExecutor._step

    def failing_step(self):
        progressed = step(self)
        if any(self._ops[-1].queues):  # the splitter holds routed bundles
            raise ValueError("late failure")
        return progressed

    monkeypatch.setattr(se.StreamingExecutor, "_step", failing_step)
    split = td.range(40, parallelism=4).streaming_split(2)
    got, errors = _drain(split)
    split.shutdown()
    assert len(errors) == 2
    assert all("late failure" in str(e) for e in errors)
    rows = sorted(x for r in got for x in r)
    assert rows and rows == list(range(len(rows)))


def test_streaming_split_iterator_pickles_to_its_channel():
    import pickle

    split = td.range(30, parallelism=3).streaming_split(1)
    payload = pickle.dumps(split[0])
    assert b"MapBatches" not in payload and len(payload) < 2000
    it = pickle.loads(payload)
    ids = [x for b in it.iter_batches(batch_size=None) for x in b["id"]]
    assert ids == list(range(30))
    split.shutdown()


def test_streaming_split_frames_larger_than_the_channel():
    """A bundle over the channel's size travels in chunks, intact."""
    ctx = DataContext.get_current()
    old = ctx.target_max_block_size
    ctx.target_max_block_size = 1024
    try:
        data = np.arange(300_000, dtype=np.int64).reshape(3000, 100)
        split = td.from_numpy(data).streaming_split(1)
    finally:
        ctx.target_max_block_size = old
    assert split.coordinator.channels[0].buffer_size < data.nbytes
    got = next(iter(split[0].iter_batches(batch_size=None,
                                          prefetch_batches=0)))
    np.testing.assert_array_equal(got["data"], data)
    split.shutdown()


def test_streaming_split_shutdown_mid_stream_raises_on_the_rank():
    split = td.range(100, parallelism=10).streaming_split(1)
    it = split[0].iter_batches(batch_size=10, prefetch_batches=0)
    first = next(it)
    split.shutdown()
    assert _segments(split) == [False]
    from ray_tpu_torch.experimental.channel import ChannelClosedError

    with pytest.raises((ChannelClosedError, FileNotFoundError)):
        rest = list(it)
        assert len(first["id"]) + sum(len(b["id"]) for b in rest) == 100


def test_split_split_at_indices_train_test_split(ray_start):
    for rd_got, rd_want in ((td, jd),):
        got = [p.count() for p in rd_got.range(100, parallelism=10).split(3)]
        want = [p.count() for p in rd_want.range(100, parallelism=10).split(3)]
        assert got == want
        got = [_rows(p) for p in rd_got.range(10).split_at_indices([3, 7])]
        want = [_rows(p) for p in rd_want.range(10).split_at_indices([3, 7])]
        assert got == want
        got = [_rows(p) for p in rd_got.range(50).train_test_split(0.2)]
        want = [_rows(p) for p in rd_want.range(50).train_test_split(0.2)]
        assert got == want
        got = [p.count() for p in rd_got.range(30).split(2, equal=True)]
        assert got == [15, 15]


def test_materialize_and_take(ray_start):
    mat = td.range(20, parallelism=2).map_batches(
        lambda b: {"id": b["id"] * 3}).materialize()
    assert mat.count() == 20 and mat.num_blocks() == 2
    assert mat.take(3) == jd.range(20, parallelism=2).map_batches(
        lambda b: {"id": b["id"] * 3}).take(3)
    assert mat.map(lambda r: {"x": r["id"]}).count() == 20


def test_actor_pool_builds_each_callable_once_per_actor():
    built = []

    class Tag:
        def __init__(self):
            built.append(threading.get_ident())

        def __call__(self, batch):
            return {"id": batch["id"],
                    "actor": np.full(len(batch["id"]), len(built))}

    rows = td.range(64, parallelism=8).map_batches(
        Tag, compute=td.ActorPoolStrategy(size=3)).take_all()
    assert sorted(r["id"] for r in rows) == list(range(64))
    assert len(built) == 3 and len(set(built)) == 3


def test_batches_are_read_only_views():
    """A user fn cannot write through a batch into its block, as the
    reference's Arrow-backed arrays cannot."""
    def bump(b):
        b["id"] += 1
        return b

    with pytest.raises(ValueError, match="read-only"):
        td.range(10).map_batches(bump).take_all()


def test_tasks_wait_get_put_streaming():
    slow = _tasks.remote(lambda s: time.sleep(s) or s)
    refs = [slow.remote(0.3), slow.remote(0.0), slow.remote(0.0)]
    ready, rest = _tasks.wait(refs, num_returns=1, timeout=5)
    assert len(ready) == 1 and ready[0] in refs[1:] and len(rest) == 2
    ready, rest = _tasks.wait(refs, num_returns=3, timeout=5)
    assert ready == refs and rest == []
    assert _tasks.get(refs) == [0.3, 0.0, 0.0]
    assert _tasks.get(_tasks.put({"a": 1})) == {"a": 1}

    def gen(n):
        for i in range(n):
            yield i
        raise KeyError("after three")

    stream = _tasks.remote(num_returns="streaming")(gen).remote(3)
    got = []
    with pytest.raises(KeyError):
        for r in stream:
            got.append(_tasks.get(r))
    assert got == [0, 1, 2]


def test_tasks_actor_runs_in_call_order_on_one_thread():
    class Counter:
        def __init__(self):
            self.seen = []

        def add(self, x):
            time.sleep(0.001 * (5 - x))
            self.seen.append((x, threading.current_thread().name))
            return list(self.seen)

    actor = _tasks.remote(Counter).remote()
    refs = [actor.add.remote(i) for i in range(5)]
    last = _tasks.get(refs[-1])
    assert [x for x, _ in last] == list(range(5))
    assert len({name for _, name in last}) == 1
    _tasks.kill(actor)


def test_pipeline_without_pyarrow_or_pandas():
    """The card's machine has neither package: the data plane must run
    with both made unimportable."""
    code = (
        "import sys\n"
        "sys.modules['pyarrow'] = None\n"
        "sys.modules['pandas'] = None\n"
        "import threading\n"
        "import numpy as np\n"
        "import torch\n"
        "import ray_tpu_torch.data as rd\n"
        "ds = rd.range(64, parallelism=4).map_batches(\n"
        "    lambda b: {'id': b['id'], 'x': b['id'] * 2.0})\n"
        "ds = ds.random_shuffle(seed=1).repartition(3)\n"
        "n = sum(len(b['x']) for b in ds.iter_torch_batches(\n"
        "    batch_size=8, dtypes={'x': torch.float32}, device='cpu'))\n"
        "split = rd.from_items([{'a': i} for i in range(20)])\\\n"
        "    .streaming_split(2, equal=True)\n"
        "got = [[], []]\n"
        "def run(i):\n"
        "    got[i] = [r['a'] for r in split[i].iter_rows()]\n"
        "ts = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]\n"
        "[t.start() for t in ts]\n"
        "[t.join(30) for t in ts]\n"
        "split.shutdown()\n"
        "assert n == 64, n\n"
        "assert sorted(got[0] + got[1]) == list(range(20)), got\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")
