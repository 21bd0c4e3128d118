"""Port parity: the native (C++) channel data plane on the CPU.

``ray_tpu_torch/_native/channel.cc`` (built with ``g++`` by
``ray_tpu_torch/_native/build.py``) behind the port's ``Channel``, held
as ``tests/test_native_channel.py`` and
``tests/test_native_hardening.py:221`` hold the reference's: a round trip,
native and Python peers in both directions, a close that wakes a blocked
native reader, backpressure and timeouts, a reader whose writer process
was killed; and the segment layout across the two packages, a reference
``Channel`` writing to a port reader on one native segment and the
reverse.  The latency comparison is not here (a loaded host makes it
flaky): ``chip_smoke.py``'s ``channel`` phase measures it on the card's
machine.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu.experimental.channel import shared_memory_channel as jchan
from ray_tpu_torch._native import build
from ray_tpu_torch.experimental.channel import shared_memory_channel as tchan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(**kw):
    ch = tchan.Channel(**kw)
    reader = tchan.Channel(ch.name, buffer_size=ch.buffer_size,
                           num_readers=ch.num_readers,
                           _create=False).set_reader_slot(0)
    return ch, reader


def test_native_lib_builds_from_the_source_with_gpp():
    path = build.lib_path("channel")
    assert path is not None, build.build_error("channel")
    assert os.path.dirname(path) == os.path.join(
        REPO, "ray_tpu_torch", "_native", "_build")
    assert tchan._native_lib() is not None


def test_without_a_toolchain_the_python_plane_and_the_reason(monkeypatch,
                                                             tmp_path):
    """No ``g++``: no library, ``build_error`` says why, and a new channel
    (``native=None``) runs the Python plane."""
    monkeypatch.setattr(build, "_BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_lib_paths", {})
    monkeypatch.setattr(build, "_build_errors", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(tchan, "_NATIVE", tchan._UNSET)
    ch = tchan.Channel(buffer_size=1 << 12)
    try:
        assert build.lib_path("channel") is None
        assert "g++" in build.build_error("channel")
        assert ch._nh is None and ch.supports_zero_copy
        flags = int.from_bytes(ch._seg.buf[16:24], "little")
        assert not flags & tchan._NATIVE_BIT
    finally:
        ch.destroy()


def test_roundtrip_native():
    ch, reader = _pair(buffer_size=1 << 16, num_readers=1)
    try:
        assert ch._nh is not None and reader._nh is not None
        assert not ch.supports_zero_copy
        for i in range(20):
            ch.write_bytes(f"payload-{i}".encode())
            assert reader.read_bytes(timeout=5) == f"payload-{i}".encode()
        # bytes-like payloads: a writable buffer in place, a view copied
        for payload in (bytearray(b"in place"), memoryview(b"a view")):
            ch.write_bytes(payload, timeout=5)
            assert reader.read_bytes(timeout=5) == bytes(payload)
        # values stage through write_bytes / read_bytes
        value = {"t": torch.arange(6, dtype=torch.bfloat16),
                 "a": np.arange(4.0), "n": 3}
        ch.write(value, timeout=5)
        got = reader.read(timeout=5)
        assert torch.equal(got["t"], value["t"]) and got["n"] == 3
        np.testing.assert_array_equal(got["a"], value["a"])
    finally:
        ch.destroy()
        reader.detach()


def test_zero_copy_path_raises_on_a_native_channel():
    ch, reader = _pair(buffer_size=1 << 12, num_readers=1)
    try:
        with pytest.raises(RuntimeError, match="native=False"):
            ch.acquire_write_buffer(8)
        ch.write_bytes(b"x", timeout=5)
        with pytest.raises(RuntimeError, match="native=False"):
            reader.read_acquire(timeout=5)
        assert reader.read_bytes(timeout=5) == b"x"
    finally:
        ch.destroy()
        reader.detach()


def test_native_false_keeps_the_python_plane():
    ch, reader = _pair(buffer_size=1 << 12, num_readers=1, native=False)
    try:
        assert ch._nh is None and reader._nh is None
        ch.write_bytes(b"py", timeout=5)
        assert reader.read_bytes(timeout=5) == b"py"
    finally:
        ch.destroy()
        reader.detach()


@pytest.mark.parametrize("writer_native,reader_native",
                         [(True, False), (False, True)])
def test_mixed_impl_interop(writer_native, reader_native):
    """Native and Python endpoints share one segment layout: either
    writes, the other reads."""
    ch, reader = _pair(buffer_size=1 << 12, num_readers=1)
    try:
        if not writer_native:
            ch._nh = None
        if not reader_native:
            reader._nh = None
        for i in range(10):
            ch.write_bytes(f"m{i}".encode(), timeout=5)
            assert reader.read_bytes(timeout=5) == f"m{i}".encode()
    finally:
        ch.destroy()
        reader.detach()


def test_close_unblocks_native_reader():
    ch, reader = _pair(buffer_size=1 << 12, num_readers=1)
    errs = []

    def waiter():
        try:
            reader.read_bytes(timeout=30)
        except tchan.ChannelClosedError:
            errs.append("closed")

    th = threading.Thread(target=waiter)
    th.start()
    time.sleep(0.05)
    t0 = time.monotonic()
    ch.close()
    th.join(10)
    assert not th.is_alive() and errs == ["closed"]
    assert time.monotonic() - t0 < 5
    ch.destroy()
    reader.detach()


def test_native_backpressure_and_timeout():
    ch, reader = _pair(buffer_size=1 << 12, num_readers=1)
    try:
        ch.write_bytes(b"one")
        # the second write waits for the unconsumed first: timeout
        with pytest.raises(tchan.ChannelTimeoutError):
            ch.write_bytes(b"two", timeout=0.1)
        assert reader.read_bytes(timeout=5) == b"one"
        ch.write_bytes(b"two", timeout=5)  # now it proceeds
        assert reader.read_bytes(timeout=5) == b"two"
        t0 = time.monotonic()
        with pytest.raises(tchan.ChannelTimeoutError):
            reader.read_bytes(timeout=0.3)
        assert 0.25 < time.monotonic() - t0 < 5
        with pytest.raises(ValueError):
            ch.write_bytes(b"x" * (1 << 13))
    finally:
        ch.destroy()
        reader.detach()


class _Interrupted(Exception):
    pass


def test_signal_reaches_a_reader_blocked_without_timeout():
    """A native wait returns to Python every 0.2 s, so a signal handler
    runs (and its exception surfaces) while ``read_bytes`` waits with no
    deadline."""
    ch, reader = _pair(buffer_size=1 << 12, num_readers=1)

    def handler(signum, frame):
        raise _Interrupted

    old = signal.signal(signal.SIGUSR1, handler)
    timer = threading.Timer(0.3, os.kill, (os.getpid(), signal.SIGUSR1))
    try:
        timer.start()
        t0 = time.monotonic()
        with pytest.raises(_Interrupted):
            reader.read_bytes()
        assert time.monotonic() - t0 < 3
    finally:
        timer.cancel()
        signal.signal(signal.SIGUSR1, old)
        ch.destroy()
        reader.detach()


def test_reader_times_out_after_its_writer_process_was_killed():
    """A reader blocked on a native channel whose writer process was
    SIGKILLed times out cleanly (futex waits with a deadline)."""
    ch = tchan.Channel(buffer_size=1 << 16, num_readers=1)
    code = (
        "import time\n"
        "from ray_tpu_torch.experimental.channel import Channel\n"
        f"w = Channel({ch.name!r}, buffer_size=1 << 16, num_readers=1, "
        "_create=False)\n"
        "assert w._nh is not None\n"
        "w.write('first')\n"
        "time.sleep(60)\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-c", code], env=env)
    reader = None
    try:
        reader = tchan.Channel(ch.name, buffer_size=1 << 16, num_readers=1,
                               _create=False).set_reader_slot(0)
        assert reader.read(timeout=60) == "first"
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
        t0 = time.monotonic()
        with pytest.raises(tchan.ChannelTimeoutError):
            reader.read(timeout=2.0)  # no second write is coming
        assert time.monotonic() - t0 < 10
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        if reader is not None:
            reader.detach()
        ch.destroy()


_VALUES = [b"raw bytes", b"", bytes(range(256)) * 3]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_native_segment_layout_across_the_packages(writer):
    """One native segment, the writer of one package and the reader of the
    other, each on its own native plane: equal bytes, then equal values
    (``write_value``/``read_value``, staged on the native plane), then the
    close seen across."""
    make_w, make_r = ((jchan, tchan) if writer == "reference"
                      else (tchan, jchan))
    ch = make_w.Channel(buffer_size=1 << 16, num_readers=1)
    rd = make_r.Channel(ch.name, buffer_size=ch.buffer_size, num_readers=1,
                        _create=False).set_reader_slot(0)
    try:
        assert ch._nh is not None and rd._nh is not None
        assert int.from_bytes(ch._seg.buf[16:24], "little") \
            & tchan._NATIVE_BIT
        for payload in _VALUES:
            ch.write_bytes(payload, timeout=5)
            assert rd.read_bytes(timeout=5) == payload
        value = {"a": np.arange(12, dtype=np.int32).reshape(3, 4), "k": "v"}
        ch.write_value(value, timeout=5)
        got = rd.read_value(timeout=5)
        np.testing.assert_array_equal(got["a"], value["a"])
        assert got["k"] == "v"
        ch.close()
        with pytest.raises((jchan.ChannelClosedError,
                            tchan.ChannelClosedError)):
            rd.read_bytes(timeout=1)
    finally:
        rd.detach()
        ch.destroy()


def test_transport_over_a_native_channel_stages_host_frames():
    """An ``EdgeTransport`` on a native channel writes staged host frames
    through ``write_bytes`` and reads owned copies, with its waits booked
    as on the Python plane; ``make_edge_transport`` keeps the Python
    plane."""
    from ray_tpu_torch.experimental.channel import transport as ttr
    from ray_tpu_torch.util import health

    assert ttr.make_edge_transport(tier=ttr.TIER_HOST).channel._nh is None
    ch, reader = _pair(buffer_size=1 << 16, num_readers=1)
    tr = ttr.EdgeTransport(ch, ttr.TIER_DEVICE, "w->r")
    rd = ttr.EdgeTransport(reader, ttr.TIER_DEVICE, "w->r", device="cpu")
    health.reset_edge_latency()
    try:
        x = torch.arange(64, dtype=torch.float32)
        tr.write({"x": x}, timeout=5)
        assert torch.equal(rd.read(timeout=5)["x"], x)
        tr.write({"x": x + 1}, timeout=5)
        assert rd.read_borrowed(lambda v: float(v["x"].sum()),
                                timeout=5) == float((x + 1).sum())
        assert tr.stats["sends"] == 2 and tr.stats["device_frames"] == 0
        assert rd.stats["recvs"] == 2
        assert health.edge_latency_snapshot()["w->r"]["count"] == 2
    finally:
        health.reset_edge_latency()
        ch.destroy()
        reader.detach()
