"""Port parity: the device ring hop on the CPU.

``device_ring_copy``'s plain path (each hop K4's plain version) against the
reference's ``ici_device_copy`` (a ``ppermute`` ring) on the 8-device CPU
mesh of ``tests/conftest.py``.  The Pallas ``_pallas_remote_copy`` is
TPU-only and never runs in the reference's tests, so ``ici_device_copy`` is
its plain reference here.  Data is made with numpy from a seed, fed to
both packages and compared as raw bits: a copy is exact.
"""

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
