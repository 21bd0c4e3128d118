"""Port parity: the device ring hop on the CPU.

``device_ring_copy``'s plain path (each hop K4's plain version) against the
reference's ``ici_device_copy`` (a ``ppermute`` ring) on the 8-device CPU
mesh of ``tests/conftest.py``.  The Pallas ``_pallas_remote_copy`` is
TPU-only and never runs in the reference's tests, so ``ici_device_copy`` is
its plain reference here.  Data is made with numpy from a seed, fed to
both packages and compared as raw bits: a copy is exact.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from ray_tpu.experimental.channel.transport import ici_device_copy
from ray_tpu_torch.experimental.channel.transport import device_ring_copy
from ray_tpu_torch.ops.cuda import remote_copy as rc

_BITS = {np.dtype(np.float32): np.uint32, np.dtype(jnp.bfloat16): np.uint16,
         np.dtype(np.int32): np.uint32}


def _blocks(dtype, n, shape, seed):
    """``n`` rank blocks of ``shape``, stacked: [n, *shape]."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-2 ** 31, 2 ** 31 - 1, size=(n, *shape),
                            dtype=np.int32)
    a = rng.standard_normal((n, *shape)).astype(np.float32)
    return a.astype(jnp.bfloat16) if dtype == "bfloat16" else a


def _to_torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16).numpy() if a.dtype == torch.bfloat16
             else a.numpy())
    a = np.asarray(a)
    return a.view(_BITS.get(a.dtype, np.uint16))


@pytest.mark.parametrize("dtype,shape", [
    ("float32", (4, 8)), ("float32", (3, 5)),      # 128 B; 60 B
    ("bfloat16", (2, 16)), ("bfloat16", (3, 3)),   # 64 B; 18 B
    ("int32", (8,)), ("int32", (7,)),              # 32 B; 28 B
])
@pytest.mark.parametrize("shift", [1, 3, -1])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_matches_ici_device_copy(n, shift, dtype, shape):
    blocks = _blocks(dtype, n, shape, seed=n * 10 + shift)
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    glob = blocks.reshape(n * shape[0], *shape[1:])
    arr = jax.device_put(glob, NamedSharding(mesh, PartitionSpec("x")))
    want = np.asarray(ici_device_copy(arr, mesh, "x", shift=shift)).reshape(
        n, *shape)
    before = rc.remote_copy.launches
    got = device_ring_copy([_to_torch(b) for b in blocks], shift=shift)
    assert rc.remote_copy.launches == before  # the CPU runs the plain copy
    assert len(got) == n
    for j in range(n):
        assert got[j].shape == shape and got[j].device.type == "cpu"
        np.testing.assert_array_equal(_bits(got[j]), _bits(want[j]))
        # block j came from rank (j - shift) mod n
        np.testing.assert_array_equal(_bits(got[j]),
                                      _bits(blocks[(j - shift) % n]))


def test_ring_results_are_fresh_tensors():
    shards = [torch.arange(6, dtype=torch.float32) + 10 * i for i in range(3)]
    out = device_ring_copy(shards)
    out[1].fill_(-1)
    assert torch.equal(shards[0], torch.arange(6, dtype=torch.float32))
    assert device_ring_copy([]) == []


def test_wrapper_refuses_misaligned_noncontiguous_and_mismatched():
    buf = torch.zeros(80, dtype=torch.uint8)
    aligned = buf[:64]
    assert aligned.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="16-byte aligned"):
        rc.remote_copy(buf[1:65], aligned)
    with pytest.raises(ValueError, match="16-byte aligned"):
        rc.remote_copy(aligned, buf[8:72])
    grid = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="contiguous"):
        rc.remote_copy(grid[:, ::2], torch.zeros(4, 4))
    with pytest.raises(ValueError, match="contiguous"):
        device_ring_copy([grid.t(), grid.t()])
    with pytest.raises(ValueError, match="one dtype and shape"):
        rc.remote_copy(torch.zeros(4), torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="one dtype and shape"):
        rc.remote_copy(torch.zeros(4), torch.zeros(2, 2))
    # no fallback: a tensor that is not on the CPU never takes copy_
    with pytest.raises(ValueError, match="between CUDA tensors"):
        rc.remote_copy(torch.empty(4, device="meta"), torch.zeros(4))


def test_plain_copy_handles_any_byte_count():
    for nbytes in (0, 1, 15, 16, 17, 1000):
        src = torch.arange(nbytes, dtype=torch.uint8)
        dst = torch.zeros(nbytes, dtype=torch.uint8)
        rc.remote_copy(src, dst)
        assert torch.equal(src, dst)


_STAGE = rc.STAGE_BYTES


def _chunks(nbytes, blocks):
    """The byte ranges [start, end) each block of K4's grid copies, as
    ``remote_copy.cu``'s ``Chunks`` deals them: the whole 16-byte vectors
    cut into chunks of one stage (the last one shorter), block b taking
    chunks b, b + blocks, ...; the last block also copies the
    nbytes % 16 bytes past them."""
    whole = nbytes // 16 * 16
    out = [[] for _ in range(blocks)]
    for i, start in enumerate(range(0, whole, _STAGE)):
        out[i % blocks].append((start, min(start + _STAGE, whole)))
    if nbytes > whole:
        out[-1].append((whole, nbytes))
    return out


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("nbytes", [
    0, 1, 15, 16, 17, _STAGE - 16, _STAGE, _STAGE + 16, 2 * _STAGE - 16,
    2 * _STAGE, 2 * _STAGE + 16, 3 * _STAGE + 48, 132 * _STAGE - 16,
    132 * _STAGE + 16, 2048 * 4096 * 2, 2048 * 4096 * 2 + 3,
])
def test_grid_chunks_cover_every_byte_once(nbytes, sms):
    """K4's grid and the chunks the kernel deals its blocks: at most one
    block per SM and never more than chunks; every byte in exactly one
    chunk; every chunk of whole 16-byte vectors starting on a 16-byte
    boundary and at most one stage long (only the last block also takes
    the < 16 bytes past them); every block has a chunk unless the copy
    has no whole vector; and the blocks' shares differ by at most one
    chunk."""
    blocks = rc.grid_blocks(nbytes, sms)
    assert 1 <= blocks <= sms
    got = _chunks(nbytes, blocks)
    covered = sorted(r for block in got for r in block)
    assert [covered[0][0], covered[-1][1]] == [0, nbytes] if nbytes \
        else covered == []
    for (_, end), (nxt, _) in zip(covered, covered[1:]):
        assert end == nxt  # no gap, no overlap
    whole = nbytes // 16 * 16
    for b, block in enumerate(got):
        for start, end in block:
            assert start % 16 == 0 and start < end
            if end <= whole:
                assert (end - start) % 16 == 0 and end - start <= _STAGE
            else:  # the tail: the last block only
                assert b == blocks - 1 and (start, end) == (whole, nbytes)
    counts = [len([r for r in block if r[1] <= whole]) for block in got]
    assert min(counts) >= 1 or whole == 0
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("nbytes,sms,blocks", [
    (0, 132, 1), (15, 132, 1), (16, 132, 1), (_STAGE, 132, 1),
    (_STAGE + 16, 132, 2), (4 * _STAGE - 16, 132, 4), (4 * _STAGE, 132, 4),
    (4 * _STAGE + 16, 3, 3), (1 << 30, 132, 132),
])
def test_grid_follows_the_stage_size(nbytes, sms, blocks):
    """One block per chunk of one stage, up to one per SM."""
    assert rc.grid_blocks(nbytes, sms) == blocks


def test_ring_fits_a_block():
    """The wrapper's ring is the one ``remote_copy.cu`` is compiled with,
    and one a block can hold: 2 to 16 stages of whole 16-byte vectors,
    within 227 KB of shared memory less the mbarriers."""
    path = os.path.join(os.path.dirname(rc.__file__), "csrc",
                        "remote_copy.cu")
    with open(path) as f:
        src = f.read()
    ring = {name: eval(expr, {}) for name, expr in re.findall(
        r"constexpr int (STAGES|STAGE_BYTES) = ([0-9 *]+);", src)}
    assert ring == {"STAGES": rc.STAGES, "STAGE_BYTES": rc.STAGE_BYTES}
    assert 2 <= rc.STAGES <= 16
    assert rc.STAGE_BYTES > 0 and rc.STAGE_BYTES % 16 == 0
    assert rc.STAGES * rc.STAGE_BYTES <= 232448 - 8 * 16


@pytest.mark.parametrize("src,dst,needed", [
    ("cuda:0", "cuda:0", False),   # one card: its stream orders the hop
    ("cuda:1", "cuda:1", False),
    ("cuda:0", "cuda:1", True),    # a peer waits on its own stream
    ("cuda:3", "cuda:0", True),
])
def test_completion_only_for_a_peer(src, dst, needed):
    assert rc.needs_completion(torch.device(src), torch.device(dst)) is needed
