"""Port parity: the compiled-graph channel plane on the CPU.

``ray_tpu_torch.experimental.channel`` against
``ray_tpu.experimental.channel``: tier negotiation on one endpoint table,
the shm segment layout and the wire layout read across the two packages
in both directions, and the transport's device frames, alias guard and
degradation under the CPU emulation of the device tier
(``RAY_TPU_TORCH_DEVICE_EMULATE=1``), as ``tests/test_channel_transport.py``
checks them for the reference.
"""

import dataclasses
import hashlib
import json
import multiprocessing
import os
import time

import numpy as np
import pytest
import torch

from ray_tpu._private import serialization as jser
from ray_tpu.experimental.channel import shared_memory_channel as jchan
from ray_tpu.experimental.channel import transport as jtr
from ray_tpu_torch._private import serialization as tser
from ray_tpu_torch._private.shm import open_shm
from ray_tpu_torch.experimental.channel import shared_memory_channel as tchan
from ray_tpu_torch.experimental.channel import transport as ttr

EMULATE = ("RAY_TPU_ICI_EMULATE", "RAY_TPU_TORCH_DEVICE_EMULATE")
_TIER = {jtr.TIER_FUSED: ttr.TIER_FUSED, jtr.TIER_DEVICE: ttr.TIER_DEVICE,
         jtr.TIER_HOST: ttr.TIER_HOST}


@pytest.fixture
def emulate(monkeypatch):
    for var in EMULATE:
        monkeypatch.setenv(var, "1")


def _endpoints(node="n1", pid=100, platform="cpu", slice_name="",
               device_ids=(0,)):
    """One endpoint for each package: TPU on a slice maps to CUDA on a
    node (the reach of device frames and peer copies)."""
    j = jtr.EndpointInfo(node_id=node, pid=pid, platform=platform,
                         slice_name=slice_name, device_ids=device_ids)
    if platform == "tpu":
        t = ttr.EndpointInfo(node_id=slice_name, pid=pid, platform="cuda",
                             device_ids=device_ids)
    else:
        t = ttr.EndpointInfo(node_id=node, pid=pid, platform=platform,
                             device_ids=device_ids)
    return j, t


_TPU_A1 = dict(pid=1, platform="tpu", slice_name="slice-a")
_TPU_A2 = dict(pid=2, platform="tpu", slice_name="slice-a")
_TPU_B2 = dict(pid=2, platform="tpu", slice_name="slice-b")
_TPU_OFF_POD = dict(pid=2, platform="tpu", slice_name="")
_NONE = dict(pid=2, platform="none", device_ids=())
# the cases of tests/test_channel_transport.py:38-78 and their neighbours
_EDGES = {
    "same_process": (dict(), dict()),
    "same_slice": (_TPU_A1, _TPU_A2),
    "cross_slice": (_TPU_A1, _TPU_B2),
    "off_pod": (dict(_TPU_OFF_POD, pid=1), _TPU_OFF_POD),
    "heterogeneous": (_TPU_A1, _NONE),
    "accelerator_to_cpu": (_TPU_A1, dict(pid=2)),
    "cpu_cross_process": (dict(pid=1), dict(pid=2)),
    "cpu_cross_node": (dict(pid=1), dict(pid=2, node="n2")),
    "cpu_to_none": (dict(pid=1), _NONE),
    "no_devices": (dict(pid=1, device_ids=()), dict(pid=2, device_ids=())),
}


@pytest.mark.parametrize("emulated", [False, True])
@pytest.mark.parametrize("edge", sorted(_EDGES))
def test_negotiation_matches_reference(edge, emulated, monkeypatch):
    for var in EMULATE:
        if emulated:
            monkeypatch.setenv(var, "1")
        else:
            monkeypatch.delenv(var, raising=False)
    (jw, tw), (jr, tr) = (_endpoints(**kw) for kw in _EDGES[edge])
    assert ttr.negotiate(tw, tr) == _TIER[jtr.negotiate(jw, jr)]
    assert ttr.negotiate(tw, None) == ttr.negotiate(None, tr) == \
        _TIER[jtr.negotiate(jw, None)] == ttr.TIER_HOST


@pytest.mark.parametrize("emulated", [False, True])
def test_channel_tier_matches_reference(emulated, monkeypatch):
    for var in EMULATE:
        if emulated:
            monkeypatch.setenv(var, "1")
        else:
            monkeypatch.delenv(var, raising=False)
    (jw, tw), (jd, td), (jh, th), (js, ts), (jt, tt) = (
        _endpoints(**kw) for kw in (dict(pid=1), dict(pid=2), _NONE,
                                    dict(pid=1, node="n2"), _TPU_A2))
    for jreaders, treaders in (([jd, jd], [td, td]), ([jd, jh], [td, th]),
                               ([], []), ([jd, js], [td, ts]),
                               ([jt], [tt]), ([jd, None], [td, None])):
        assert ttr.negotiate_channel(tw, treaders) == \
            _TIER[jtr.negotiate_channel(jw, jreaders)]
    # a TPU writer on slice-a (a CUDA writer on node slice-a)
    (jw, tw) = _endpoints(**_TPU_A1)
    assert ttr.negotiate_channel(tw, [tt, tt]) == \
        _TIER[jtr.negotiate_channel(jw, [jt, jt])] == ttr.TIER_DEVICE


def test_hosts_sharing_a_hostname_negotiate_the_host_tier(
        emulate, monkeypatch, tmp_path):
    """Two processes with one hostname share a node only when they also
    share the kernel's boot id: containers made from one image do not."""
    monkeypatch.setattr(ttr.socket, "gethostname", lambda: "same-name")

    def info_under(boot_id, pid):
        path = tmp_path / f"boot_id_{boot_id}"
        path.write_text(boot_id + "\n")
        monkeypatch.setattr(ttr, "_HOST_ID_FILES",
                            (str(path), str(tmp_path / "no-machine-id")))
        return dataclasses.replace(ttr.local_endpoint_info(), pid=pid)

    a, b, c = info_under("boot-a", 1), info_under("boot-b", 2), \
        info_under("boot-a", 3)
    assert a.node_id == c.node_id == "same-name/boot-a" != b.node_id
    assert ttr.negotiate(a, b) == ttr.negotiate(b, a) == ttr.TIER_HOST
    assert ttr.negotiate(a, c) == ttr.TIER_DEVICE
    assert ttr.negotiate_channel(a, [b, c]) == ttr.TIER_HOST
    # neither file readable: the hostname alone
    monkeypatch.setattr(ttr, "_HOST_ID_FILES", (str(tmp_path / "none"),))
    assert ttr.local_endpoint_info().node_id == "same-name"


def test_local_endpoint_info_is_passive(monkeypatch):
    monkeypatch.delenv("RAY_TPU_TORCH_DEVICE_EMULATE", raising=False)
    info = ttr.local_endpoint_info()
    assert info.pid == os.getpid() and info.node_id
    assert info.platform == "none" and not info.holds_devices()
    assert not torch.cuda.is_initialized()
    monkeypatch.setenv("RAY_TPU_TORCH_DEVICE_EMULATE", "1")
    a, b = ttr.local_endpoint_info(), ttr.local_endpoint_info()
    assert a.platform == "cpu" and a.holds_devices()
    assert ttr.negotiate(a, b) == ttr.TIER_FUSED
    assert ttr.negotiate(a, ttr.EndpointInfo(
        node_id=a.node_id, pid=a.pid + 1, platform="cpu",
        device_ids=(0,))) == ttr.TIER_DEVICE


# ---------------------------------------------------------------------------
# Layouts shared with the reference
# ---------------------------------------------------------------------------

_VALUES = [b"one", {"a": np.arange(2048, dtype=np.float64), "s": "x"},
           [np.ones((3, 5), np.float32), (1, 2.5, None), {"k": b"v"}]]


def _assert_same(got, want):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    else:
        assert got == want


def test_segment_layout_port_writes_reference_reads():
    ch = tchan.Channel(buffer_size=1 << 16)
    rd = jchan.Channel(ch.name, buffer_size=ch.buffer_size, num_readers=1,
                       _create=False).set_reader_slot(0)
    try:
        ch.write_bytes(b"raw bytes", timeout=5)
        assert rd.read_bytes(timeout=5) == b"raw bytes"
        for value in _VALUES:
            ch.write_value(value, timeout=5)
            _assert_same(rd.read_value(timeout=5), value)
        ch.close()
        with pytest.raises(jchan.ChannelClosedError):
            rd.read_bytes(timeout=1)
    finally:
        rd.detach()
        ch.destroy()


def test_segment_layout_reference_writes_port_reads():
    ch = jchan.Channel(buffer_size=1 << 16, num_readers=2, native=False)
    rd = tchan.Channel(ch.name, buffer_size=ch.buffer_size, num_readers=2,
                       _create=False).set_reader_slot(1)
    ch._set_ack(0, 1 << 40)  # slot 0 never reads: keep it out of the way
    try:
        ch.write_bytes(b"raw bytes", timeout=5)
        assert rd.read_bytes(timeout=5) == b"raw bytes"
        for value in _VALUES:
            ch.write_value(value, timeout=5)
            _assert_same(rd.read_value(timeout=5, device="cpu"), value)
        ch.close()
        with pytest.raises(tchan.ChannelClosedError):
            rd.read_bytes(timeout=1)
    finally:
        rd.detach()
        ch.destroy()


def test_wire_layout_port_frame_decodes_in_reference():
    tr = ttr.make_edge_transport(tier=ttr.TIER_HOST, buffer_size=1 << 16)
    rd = jchan.Channel(tr.name, buffer_size=tr.channel.buffer_size,
                       num_readers=1, _create=False).set_reader_slot(0)
    try:
        for value in _VALUES:
            tr.write(value, timeout=5)
            view, version = rd.read_acquire(timeout=5)
            assert int.from_bytes(view[:8], "little") == 0  # host marker
            got, refs = jser.deserialize(view[64:], zero_copy=False)
            rd.read_release(version)
            assert refs == []
            _assert_same(got, value)
    finally:
        rd.detach()
        tr.destroy()


def test_wire_layout_reference_frame_decodes_in_port():
    jt = jtr.make_edge_transport(tier=jtr.TIER_HOST, buffer_size=1 << 16)
    rd = ttr.EdgeTransport(
        tchan.Channel(jt.name, buffer_size=jt.channel.buffer_size,
                      _create=False).set_reader_slot(0), device="cpu")
    try:
        for value in _VALUES:
            jt.write(value, timeout=5)
            _assert_same(rd.read(timeout=5), value)
        # and the serializers alone, byte string to byte string
        for value in _VALUES:
            _assert_same(tser.deserialize(jser.serialize(value)[0],
                                          device="cpu"), value)
            core, raw_bufs, total = tser.serialize_parts(value)
            out = bytearray(total)
            tser.write_parts(out, core, raw_bufs)
            _assert_same(jser.deserialize(bytes(out))[0], value)
    finally:
        rd.channel.detach()
        jt.destroy()


def test_host_frame_copies_payload_once():
    """The writer packs out-of-band buffers straight into the segment: the
    bytes copied stay within 15 % of the payload (one copy, not two)."""
    tr = ttr.make_edge_transport(tier=ttr.TIER_HOST, buffer_size=1 << 22)
    rd = ttr.attach_edge_transport(tr, 0, device="cpu")
    try:
        tchan.reset_copy_stats()
        payload = {"a": np.arange(1 << 16, dtype=np.float64), "n": 7,
                   "t": torch.arange(1 << 14, dtype=torch.float32)}
        tr.write(payload, timeout=5)
        stats = dict(tchan.COPY_STATS)
        assert stats["payloads"] == 1
        assert stats["bytes_copied"] <= 1.15 * stats["payload_bytes"], stats
        assert stats["payload_bytes"] >= payload["a"].nbytes + 4 * (1 << 14)
        out = rd.read(timeout=5)
        np.testing.assert_array_equal(out["a"], payload["a"])
        assert torch.equal(out["t"], payload["t"]) and out["n"] == 7
    finally:
        rd.channel.detach()
        tr.destroy()


def test_tensors_land_on_the_card_unless_the_cpu_is_asked_for():
    """``device=None`` means the card, as at every entry point of the
    port: without CUDA a tensor payload raises, while a payload with no
    tensor still decodes and ``device="cpu"`` lands tensors on the host."""
    ch = tchan.Channel(buffer_size=1 << 16)
    rd = tchan.Channel(ch.name, buffer_size=ch.buffer_size,
                       _create=False).set_reader_slot(0)
    try:
        x = torch.arange(12, dtype=torch.bfloat16).reshape(3, 4)
        core, raw_bufs, total = tser.serialize_parts({"x": x})
        frame = bytearray(total)
        tser.write_parts(frame, core, raw_bufs)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tser.deserialize(bytes(frame))
        got = tser.deserialize(bytes(frame), device="cpu")["x"]
        assert got.device == torch.device("cpu") and torch.equal(got, x)
        ch.write_value({"x": x}, timeout=5)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            rd.read_value(timeout=5)
        ch.write_value({"n": 1, "a": np.ones(3)}, timeout=5)
        got = rd.read_value(timeout=5)
        assert got["n"] == 1 and np.array_equal(got["a"], np.ones(3))
        ch.write_value({"x": x}, timeout=5)
        assert torch.equal(rd.read_value(timeout=5, device="cpu")["x"], x)
    finally:
        rd.detach()
        ch.destroy()


def test_native_mode_segment_is_refused(monkeypatch):
    """A process that cannot load the native plane refuses a native-mode
    segment on a weakly-ordered host (its plain stores would race the
    native peers' acquire loads); under total store order it joins on the
    Python plane."""
    ch = tchan.Channel(buffer_size=64, native=False)
    try:
        word = int.from_bytes(ch._seg.buf[16:24], "little")
        ch._seg.buf[16:24] = (word | tchan._NATIVE_BIT).to_bytes(8, "little")
        monkeypatch.setattr(tchan, "_native_lib", lambda: None)
        monkeypatch.setattr(tchan, "_TSO", False)
        with pytest.raises(RuntimeError, match="native data plane"):
            tchan.Channel(ch.name, buffer_size=64, _create=False)
        monkeypatch.setattr(tchan, "_TSO", True)
        rd = tchan.Channel(ch.name, buffer_size=64, _create=False)
        assert rd._nh is None and rd.supports_zero_copy
        rd.detach()
    finally:
        ch.destroy()


# ---------------------------------------------------------------------------
# The transport under the emulated device tier
# ---------------------------------------------------------------------------


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64])
def test_device_frame_round_trip_bit_exact(dtype, emulate):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((33, 17)).astype(np.float32)
                         * 1e3).to(dtype)
    tr = ttr.make_edge_transport(tier=ttr.TIER_DEVICE, buffer_size=1 << 20)
    rd = ttr.attach_edge_transport(tr, 0, device="cpu")
    try:
        tr.write({"x": x, "step": 3, "rows": [x[0], x[-1]]}, timeout=5)
        out = rd.read(timeout=5)
        assert tr.stats["device_frames"] == 1 and out["step"] == 3
        for got, want in ((out["x"], x), (out["rows"][0], x[0]),
                          (out["rows"][1], x[-1])):
            assert got.dtype == dtype and got.shape == want.shape
            assert torch.equal(_bits(got), _bits(want))
        # read() owns its tensors: the next write does not touch them
        tr.write({"x": torch.zeros_like(x)}, timeout=5)
        assert rd.read_borrowed(lambda v: float(v["x"].float().abs().sum()),
                                timeout=5) == 0.0
        assert torch.equal(_bits(out["x"]), _bits(x))
    finally:
        rd.channel.detach()
        tr.destroy()


def test_numpy_leaf_forces_host_frame(emulate):
    tr = ttr.make_edge_transport(tier=ttr.TIER_DEVICE, buffer_size=1 << 20)
    rd = ttr.attach_edge_transport(tr, 0, device="cpu")
    try:
        tr.write({"x": torch.ones(8), "y": np.ones(8)}, timeout=5)
        out = rd.read(timeout=5)
        assert tr.stats["device_frames"] == 0 and tr.stats["sends"] == 1
        np.testing.assert_array_equal(out["y"], np.ones(8))
        assert torch.equal(out["x"], torch.ones(8))
        tr.write({"n": 1}, timeout=5)  # no tensor: host frame too
        assert rd.read(timeout=5) == {"n": 1}
        assert tr.stats["device_frames"] == 0
    finally:
        rd.channel.detach()
        tr.destroy()


def test_oversize_write_raises_value_error(emulate):
    for tier in (ttr.TIER_HOST, ttr.TIER_DEVICE):
        tr = ttr.make_edge_transport(tier=tier, buffer_size=1 << 10)
        try:
            with pytest.raises(ValueError, match="exceeds"):
                tr.write(torch.zeros(1 << 10), timeout=1)
            assert tr.stats["degraded"] == 0 and tr.tier == tier
        finally:
            tr.destroy()


def test_overwrite_while_borrowed_view_live_raises(emulate):
    tr = ttr.make_edge_transport(tier=ttr.TIER_DEVICE, buffer_size=1 << 16)
    rd = ttr.attach_edge_transport(tr, 0, device="cpu")
    try:
        tr.write({"x": torch.arange(16.0)}, timeout=5)
        # the protocol holds the writer off while the borrow is live ...
        with pytest.raises(tchan.ChannelTimeoutError):
            rd.read_borrowed(
                lambda v: tr.write({"x": torch.zeros(16)}, timeout=0.2),
                timeout=5)
        # ... and a rogue publish under a live borrow is caught at release
        tr.write({"x": torch.arange(16.0)}, timeout=5)
        with pytest.raises(RuntimeError, match="overwritten while"):
            rd.read_borrowed(lambda v: tr.channel.commit_write(64),
                             timeout=5)
    finally:
        rd.channel.detach()
        tr.destroy()


def test_read_borrowed_consumes_in_scope(emulate):
    tr = ttr.make_edge_transport(tier=ttr.TIER_DEVICE, buffer_size=1 << 16)
    rd = ttr.attach_edge_transport(tr, 0, device="cpu")
    try:
        tr.write({"x": torch.arange(1024, dtype=torch.float32)}, timeout=5)
        total = rd.read_borrowed(lambda v: float(v["x"].sum()), timeout=5)
        assert total == float(np.arange(1024, dtype=np.float32).sum())
        tr.write({"x": torch.zeros(1024)}, timeout=5)
        assert rd.read_borrowed(lambda v: float(v["x"].sum()),
                                timeout=5) == 0.0
        assert rd.stats["recvs"] == 2 and tr.stats["device_frames"] == 2
    finally:
        rd.channel.detach()
        tr.destroy()


def _hooked(package):
    """Count one package's ``channel_wait`` notes from now on, its edge
    table cleared: returns (notes, stop, snapshot)."""
    if package == "reference":
        from ray_tpu._private import tracing as sinks
        from ray_tpu.util import health
    else:
        from ray_tpu_torch._private import durations as sinks
        from ray_tpu_torch.util import health
    notes = []
    token = sinks.register_duration_sink(
        lambda bucket, dt: notes.append(dt) if bucket == "channel_wait"
        else None)
    health.reset_edge_latency()
    return (notes, lambda: sinks.unregister_duration_sink(token),
            health.edge_latency_snapshot)


def test_read_borrowed_books_acquire_and_decode_only():
    """A borrowed read books its acquire and decode only, in both
    packages: a consumer that sleeps 0.3 s adds nothing to the
    transport's wait, its ``channel_wait`` note or its edge's latency,
    while ``read`` books one note per read on its edge."""
    booked = {}
    for package, mod in (("reference", jtr), ("port", ttr)):
        tr = mod.make_edge_transport(tier=mod.TIER_HOST, buffer_size=1 << 16,
                                     edge="s0->s1")
        rd = (jtr.attach_edge_transport(tr, 0) if package == "reference"
              else ttr.attach_edge_transport(tr, 0, device="cpu"))
        notes, stop, snapshot = _hooked(package)
        try:
            tr.write({"n": 1}, timeout=5)
            t0 = time.perf_counter()
            got = rd.read_borrowed(lambda v: time.sleep(0.3) or v["n"],
                                   timeout=5)
            wall = time.perf_counter() - t0
            tr.write({"n": 2}, timeout=5)
            assert rd.read(timeout=5)["n"] == 2
            edges = snapshot()
        finally:
            stop()
            rd.channel.detach()
            tr.destroy()
        assert got == 1 and wall >= 0.3
        assert len(notes) == 2 and notes[0] < 0.2, (package, notes)
        assert rd.stats["read_wait_s"] == pytest.approx(sum(notes))
        booked[package] = {e: st["count"] for e, st in edges.items()}
    assert booked["port"] == booked["reference"] == {"s0->s1": 2}


def test_step_record_of_a_reader_carries_edges(monkeypatch):
    """A step that reads a channel books the read to ``channel_wait``, and
    the step record the ledger publishes to the run's KV carries the
    edge's latency under ``edges`` (the health plane's input)."""
    from ray_tpu_torch._private import kv as kv_mod
    from ray_tpu_torch.train.session import StepLedger
    from ray_tpu_torch.util import health

    store = kv_mod.host()
    monkeypatch.setenv(kv_mod.ENV_KV, store.addr)
    health.reset_edge_latency()
    tr = ttr.make_edge_transport(tier=ttr.TIER_HOST, buffer_size=1 << 12,
                                 edge="stage0->stage1")
    rd = ttr.attach_edge_transport(tr, 0, device="cpu")
    try:
        ledger = StepLedger(group_name="edges", rank=3)
        with ledger.step():
            tr.write(7, timeout=5)
            assert rd.read(timeout=5) == 7
        buckets = ledger.last_breakdown()["buckets"]
        rec = json.loads(store.get("train/step_breakdown/edges/3"))
    finally:
        health.reset_edge_latency()
        rd.channel.detach()
        tr.destroy()
    assert buckets["channel_wait"] == pytest.approx(rd.stats["read_wait_s"])
    assert rec["edges"]["stage0->stage1"]["count"] == 1
    assert rec["last"]["buckets"]["channel_wait"] == buckets["channel_wait"]


def test_device_decode_failure_degrades_to_host(emulate, monkeypatch):
    tr = ttr.make_edge_transport(tier=ttr.TIER_DEVICE, buffer_size=1 << 16)
    rd = ttr.attach_edge_transport(tr, 0, device="cpu")
    try:
        tr.write({"x": torch.arange(256, dtype=torch.float32)}, timeout=5)
        assert tr.stats["device_frames"] == 1

        class _Boom:
            def __init__(self, *a, **kw):
                raise RuntimeError("device landing broken")

        monkeypatch.setattr(tser, "device_rebuild_guard", _Boom)
        out = rd.read(timeout=5)  # the decode degrades, the value arrives
        assert torch.equal(out["x"], torch.arange(256, dtype=torch.float32))
        assert rd.tier == ttr.TIER_HOST and rd.stats["degraded"] == 1
        monkeypatch.undo()
        # sticky: no further flapping
        tr.write({"x": torch.ones(4)}, timeout=5)
        assert torch.equal(rd.read(timeout=5)["x"], torch.ones(4))
        assert rd.tier == ttr.TIER_HOST and rd.stats["degraded"] == 1
    finally:
        rd.channel.detach()
        tr.destroy()


def test_device_encode_failure_degrades_to_host(emulate, monkeypatch):
    tr = ttr.make_edge_transport(tier=ttr.TIER_DEVICE, buffer_size=1 << 16)
    rd = ttr.attach_edge_transport(tr, 0, device="cpu")
    try:
        real = tser.serialize_parts
        calls = []

        def flaky(value):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("device encode broken")
            return real(value)

        monkeypatch.setattr(tser, "serialize_parts", flaky)
        tr.write({"x": torch.ones(4)}, timeout=5)
        assert tr.tier == ttr.TIER_HOST and tr.stats["degraded"] == 1
        assert tr.stats["device_frames"] == 0 and tr.stats["sends"] == 1
        assert torch.equal(rd.read(timeout=5)["x"], torch.ones(4))
    finally:
        rd.channel.detach()
        tr.destroy()


def test_transport_pickles_by_name():
    import pickle

    tr = ttr.make_edge_transport(tier=ttr.TIER_HOST, edge="a->b")
    try:
        back = pickle.loads(pickle.dumps(tr))
        assert (back.name, back.tier, back.edge, back.device) == \
            (tr.name, tr.tier, "a->b", None)
        back.channel.detach()
        rd = ttr.attach_edge_transport(tr, 0, device="cpu")
        assert pickle.loads(pickle.dumps(rd)).device == torch.device("cpu")
        rd.channel.detach()
    finally:
        tr.destroy()


# ---------------------------------------------------------------------------
# Two processes
# ---------------------------------------------------------------------------


def _digest(t):
    return hashlib.sha256(_bits(t).contiguous().numpy().tobytes()).hexdigest()


def _channel_peer(forward, back, frames):
    """The reader process: negotiate from its own endpoint info, read
    ``frames`` device frames borrowed, send the digests back."""
    info = ttr.local_endpoint_info()
    rd = ttr.attach_edge_transport(forward, 0, device="cpu")
    forward.channel.detach()
    try:
        digests = [rd.read_borrowed(lambda v: (v["step"], _digest(v["x"])),
                                    timeout=60) for _ in range(frames)]
        back.write({"info": info, "digests": digests,
                    "stats": rd.stats}, timeout=60)
    finally:
        rd.channel.detach()
        back.channel.detach()


def test_two_process_round_trip(emulate):
    frames = 4
    forward = ttr.make_edge_transport(tier=ttr.TIER_DEVICE,
                                      buffer_size=1 << 16)
    back = ttr.make_edge_transport(tier=ttr.TIER_HOST, buffer_size=1 << 16)
    reply = ttr.attach_edge_transport(back, 0, device="cpu")
    proc = multiprocessing.get_context("spawn").Process(
        target=_channel_peer, args=(forward, back, frames), daemon=True)
    try:
        proc.start()
        sent = []
        for step in range(frames):
            x = torch.randn(64, 32, generator=torch.Generator().manual_seed(
                step)).to(torch.bfloat16)
            forward.write({"x": x, "step": step}, timeout=60)
            sent.append((step, _digest(x)))
        got = reply.read(timeout=120)
        proc.join(timeout=60)
        assert not proc.is_alive() and proc.exitcode == 0
        assert [tuple(d) for d in got["digests"]] == sent
        mine = ttr.local_endpoint_info()
        assert ttr.negotiate(mine, got["info"]) == ttr.TIER_DEVICE
        assert ttr.negotiate(got["info"], mine) == ttr.TIER_DEVICE
        assert forward.stats["device_frames"] == frames
        assert got["stats"]["recvs"] == frames
        assert got["stats"]["degraded"] == 0
    finally:
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=10)
        reply.channel.detach()
        forward.destroy()
        back.destroy()
    for name in (forward.name, back.name):
        with pytest.raises(FileNotFoundError):
            open_shm(name=name)
