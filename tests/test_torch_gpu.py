"""The port's CUDA kernels on the card against their plain versions.

Marked ``gpu``: they skip without a CUDA device.  This file imports
neither JAX nor the JAX package, so on the card it runs without the
shared ``tests/conftest.py`` (which sets up JAX on the CPU):
``python -m pytest tests/test_torch_gpu.py -m gpu --noconftest``.
"""

import os

import pytest
import torch

from ray_tpu_torch.ops.cuda import flash_attention as flash

# chip_smoke.py's BWD_TOL: per output (dq, dk, dv) atol, rtol and relative
# L2 limit, bf16 and fp32
BWD_ATOL = (2e-3, 8e-3, 1.6e-2)
BWD_ATOL_FP32 = (2e-6, 2.5e-5, 5e-5)


def assert_bwd_close(got, want, atol, dtype=torch.bfloat16):
    rtol, rel_l2_max = ((2 ** -7, 1e-3) if dtype == torch.bfloat16
                        else (1e-5, 1e-5))
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
    rel_l2 = torch.linalg.vector_norm(got - want) \
        / torch.linalg.vector_norm(want)
    assert rel_l2 <= rel_l2_max, rel_l2


@pytest.mark.gpu
def test_flash_kernel_matches_plain_on_card():
    """K1 on the card against its plain version (bf16, GQA, ragged)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU or interpret mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(1, 300, 8, 128, generator=gen, device="cuda").bfloat16()
    k = torch.randn(1, 300, 2, 128, generator=gen, device="cuda").bfloat16()
    v = torch.randn(1, 300, 2, 128, generator=gen, device="cuda").bfloat16()
    before = flash.flash_attention_fwd.launches
    out, lse = flash.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash.flash_attention_fwd.launches == before + 1
    pout, plse = flash.flash_attention_plain(q, k, v, causal=True)
    # bf16 output rounding and P cast to bf16 before PV
    torch.testing.assert_close(out.float(), pout.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, plse, atol=1e-3, rtol=0)


@pytest.mark.gpu
def test_bwd_kernels_match_plain_on_card():
    """K2 and K3 on the card against their plain version (bf16, GQA,
    ragged), and the op's autograd launching K1, K2 and K3 once each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2/K3 have no CPU or interpret "
                    "mode")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    q, k, v, do = (randn(1, 300, 8, 128), randn(1, 300, 2, 128),
                   randn(1, 300, 2, 128), randn(1, 300, 8, 128))
    out, lse = flash.flash_attention_fwd(q, k, v)
    got = flash.flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    want = flash.flash_attention_bwd_plain(q, k, v, out, lse, do)
    # chip_smoke.py's BWD_TOL["bfloat16"]: both sides round P, dS and the
    # outputs to bf16, so a differing element is off by about one ulp
    # (rtol 2^-7); atol twice the largest H100 readings of dq, dk, dv; the
    # relative L2 error catches a systematic error (1% scale: 1e-2)
    for a, w, atol in zip(got, want, BWD_ATOL):
        assert_bwd_close(a, w, atol)
    counts = (flash.flash_attention_fwd.launches,
              flash.flash_attention_bwd.dq_launches,
              flash.flash_attention_bwd.dkv_launches)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    flash.flash_attention(qg, kg, vg).backward(do)
    torch.cuda.synchronize()
    assert (flash.flash_attention_fwd.launches,
            flash.flash_attention_bwd.dq_launches,
            flash.flash_attention_bwd.dkv_launches) == tuple(
                c + 1 for c in counts)
    assert_bwd_close(qg.grad, want[0], BWD_ATOL[0])


@pytest.mark.gpu
def test_auto_attention_head_dim_16_on_card():
    """'auto' on a shape K1 does not take (head_dim 16, s >= 256) computes
    through the reference instead of raising, and matches
    ``reference_attention`` within K1's tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ray_tpu_torch.ops.attention import (dot_product_attention,
                                             reference_attention)

    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(2, 256, 4, 16, generator=gen, device="cuda")
    k = torch.randn(2, 256, 2, 16, generator=gen, device="cuda")
    v = torch.randn(2, 256, 2, 16, generator=gen, device="cuda")
    before = flash.flash_attention_fwd.launches
    got = dot_product_attention(q, k, v, causal=True)
    assert flash.flash_attention_fwd.launches == before
    torch.testing.assert_close(got, reference_attention(q, k, v),
                               atol=2e-2, rtol=2e-2)
    with pytest.raises(ValueError, match="head_dim"):
        dot_product_attention(q, k, v, impl="flash")


# (b, s, h, kv_h, d, dtype, causal, layout): "contiguous" [b, s, h, d];
# "head_slices", heads sliced out of one wider [b, s, heads, d] tensor;
# "head_major", [b, h, s, d] storage seen as [b, s, h, d]
KERNEL_CASES = {
    "bf16_causal_s300": (1, 300, 8, 8, 128, torch.bfloat16, True,
                         "contiguous"),
    "bf16_causal_s1000": (1, 1000, 4, 4, 128, torch.bfloat16, True,
                          "contiguous"),
    "bf16_gqa_nrep4": (1, 512, 16, 4, 128, torch.bfloat16, True,
                       "contiguous"),
    "bf16_non_causal_d64": (2, 333, 4, 4, 64, torch.bfloat16, False,
                            "contiguous"),
    "bf16_head_slices": (2, 320, 4, 2, 128, torch.bfloat16, True,
                         "head_slices"),
    "bf16_head_major": (2, 300, 8, 2, 128, torch.bfloat16, True,
                        "head_major"),
    "fp32_fma": (1, 300, 4, 2, 128, torch.float32, True, "contiguous"),
    # the edges of K2's tiling (128 q rows per block, 64 per warpgroup):
    # fewer rows than one warpgroup, one row past a block, the main path
    "bf16_causal_s40": (1, 40, 4, 4, 128, torch.bfloat16, True,
                        "contiguous"),
    "bf16_causal_s129": (1, 129, 4, 2, 128, torch.bfloat16, True,
                         "contiguous"),
    "bf16_main_path": (1, 2048, 32, 32, 128, torch.bfloat16, True,
                       "contiguous"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_flash_kernels_match_plain_across_layouts_on_card(case):
    """K1, K2 and K3 against their plain versions at the tolerances of
    ``chip_smoke.py`` (K1: bf16 O atol = rtol = 2e-2, lse 1e-3; fp32 1e-4;
    K2/K3: ``BWD_TOL``): ragged causal lengths, GQA, non-causal d=64, q/k/v
    that are strided views with unit d-stride (head slices of one wider
    tensor, head-major storage), and fp32, which takes the FMA kernels.
    One autograd step of ``flash_attention`` launches each kernel once and
    matches the plain gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1-K3 have no CPU or interpret "
                    "mode")
    b, s, h, kv_h, d, dtype, causal, layout = KERNEL_CASES[case]
    gen = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    if layout == "head_slices":
        qkv = randn(b, s, h + 2 * kv_h + 2, d)
        q, k, v = (qkv[:, :, :h], qkv[:, :, h:h + kv_h],
                   qkv[:, :, h + kv_h:h + 2 * kv_h])
    elif layout == "head_major":
        q, k, v = (randn(b, heads, s, d).transpose(1, 2)
                   for heads in (h, kv_h, kv_h))
    else:
        q, k, v = (randn(b, s, h, d), randn(b, s, kv_h, d),
                   randn(b, s, kv_h, d))
    assert q.is_contiguous() == (layout == "contiguous") and q.stride(3) == 1
    do = randn(b, s, h, d)
    counts = (flash.flash_attention_fwd.launches,
              flash.flash_attention_bwd.dq_launches,
              flash.flash_attention_bwd.dkv_launches)
    out, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
    got = flash.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    pout, plse = flash.flash_attention_plain(q, k, v, causal=causal)
    want = flash.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                           causal=causal)
    if dtype == torch.bfloat16:
        tol_o, tol_lse, atols = 2e-2, 1e-3, BWD_ATOL
    else:
        tol_o, tol_lse, atols = 1e-4, 1e-4, BWD_ATOL_FP32
    torch.testing.assert_close(out.float(), pout.float(), atol=tol_o,
                               rtol=tol_o)
    torch.testing.assert_close(lse, plse, atol=tol_lse, rtol=0)
    for a, w, atol in zip(got, want, atols):
        assert_bwd_close(a, w, atol, dtype)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    flash.flash_attention(qg, kg, vg, causal=causal).backward(do)
    torch.cuda.synchronize()
    assert (flash.flash_attention_fwd.launches,
            flash.flash_attention_bwd.dq_launches,
            flash.flash_attention_bwd.dkv_launches) == tuple(
                c + 2 for c in counts)  # the direct calls and the step
    for grad, w, atol in zip((qg.grad, kg.grad, vg.grad), want, atols):
        assert_bwd_close(grad, w, atol, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,design,other", [
    (torch.bfloat16, "flash_bwd_dq_wgmma_kernel", "flash_bwd_dq_kernel"),
    (torch.float32, "flash_bwd_dq_kernel", "flash_bwd_dq_wgmma_kernel"),
])
def test_bwd_dq_kernel_design_by_dtype_on_card(dtype, design, other):
    """By torch.profiler's kernel names, a bf16 backward runs K2 on the
    tensor cores (``flash_bwd_dq_wgmma_kernel``) and an fp32 one on the
    FMA kernel (``flash_bwd_dq_kernel``), once each and never the other:
    no launch falls back to the other design."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2 has no CPU or interpret mode")
    gen = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v, do = (randn(1, 256, 4, 128), randn(1, 256, 2, 128),
                   randn(1, 256, 2, 128), randn(1, 256, 4, 128))
    out, lse = flash.flash_attention_fwd(q, k, v)
    names = _cuda_kernels(lambda: flash.flash_attention_bwd(q, k, v, out,
                                                             lse, do))
    assert len([n for n in names if design in n]) == 1, names
    assert not [n for n in names if other in n], names


@pytest.mark.gpu
def test_auto_attention_d_strided_on_card():
    """'auto' on a bf16 input whose head dimension is strided (s=256, where
    'auto' would pick the flash kernels) computes through the reference
    instead of raising, and matches ``reference_attention`` within K1's
    tolerance; an explicit ``impl='flash'`` still raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ray_tpu_torch.ops.attention import (dot_product_attention,
                                             reference_attention)

    gen = torch.Generator(device="cuda").manual_seed(6)
    wide = torch.randn(1, 256, 12, 256, generator=gen,
                       device="cuda").bfloat16()
    q, k, v = wide[:, :, :8, ::2], wide[:, :, 8:10, ::2], wide[:, :, 10:, ::2]
    assert q.shape == (1, 256, 8, 128) and q.stride(3) == 2
    before = flash.flash_attention_fwd.launches
    got = dot_product_attention(q, k, v, causal=True)
    assert flash.flash_attention_fwd.launches == before
    torch.testing.assert_close(got.float(),
                               reference_attention(q, k, v).float(),
                               atol=2e-2, rtol=2e-2)
    with pytest.raises(ValueError, match="unit stride"):
        dot_product_attention(q, k, v, impl="flash")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [
    ((1, 2048, 4096), torch.bfloat16),  # 16 MiB, the main-path payload
    ((3, 7), torch.float32),            # 84 B: 5 vectors and a tail
    ((37,), torch.int8),                # 37 B: 2 vectors and a tail
])
def test_remote_copy_matches_copy_on_card(shape, dtype):
    """K4 against ``copy_``, bit-exact, one launch per hop, on one card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 has no CPU or interpret mode")
    from ray_tpu_torch.experimental.channel.transport import device_ring_copy
    from ray_tpu_torch.ops.cuda import remote_copy as rc

    gen = torch.Generator(device="cuda").manual_seed(2)
    shards = [torch.randint(-100, 100, shape, generator=gen, device="cuda")
              .to(dtype) for _ in range(4)]
    src, dst = shards[0], torch.full_like(shards[0], 7)
    before = rc.remote_copy.launches
    rc.remote_copy(src, dst)
    rc.check_remote_copies()
    assert rc.remote_copy.launches == before + 1
    assert torch.equal(dst, src)
    for shift in (1, 3):
        launched = rc.remote_copy.launches
        out = device_ring_copy(shards, shift=shift)
        assert rc.remote_copy.launches == launched + 4  # one per hop
        for i, x in enumerate(shards):
            assert torch.equal(out[(i + shift) % 4], x)


@pytest.mark.gpu
def test_remote_copy_wait_timeout_raises():
    """A wait whose flag never reaches its epoch gives up after its bound
    and the wrapper raises; the next flagged hop of that completion works
    again.  One card has no peer, so the completion is made through the
    private launcher, as a hop onto a peer makes it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 has no CPU or interpret mode")
    from ray_tpu_torch.ops.cuda import remote_copy as rc

    x = torch.arange(64, dtype=torch.float32, device="cuda")
    y = torch.empty_like(x)
    lib = rc._lib()
    stream = torch.cuda.current_stream(x.device)
    comp = rc._completion(lib, x.device, y.device, stream.cuda_stream)
    rc._flagged_hop(lib, x, y, comp, stream)
    rc.check_remote_copies()
    rc._launch_wait(lib, comp, comp.epoch + 1000, timeout_s=1e-3)
    with pytest.raises(RuntimeError, match="timed out"):
        rc.check_remote_copies()
    rc._flagged_hop(lib, x * 2, y, comp, stream)
    rc.check_remote_copies()
    assert torch.equal(y, x * 2)


@pytest.mark.gpu
def test_remote_copy_two_streams_on_one_pair():
    """Flagged hops between one pair of devices from two streams at once
    (one card standing in for the pair, through the private launcher):
    each stream has its own completion, and work queued after a hop's
    wait on its stream sees every byte of that hop, never a half-copied
    buffer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 has no CPU or interpret mode")
    from ray_tpu_torch.ops.cuda import remote_copy as rc

    gen = torch.Generator(device="cuda").manual_seed(3)
    lib = rc._lib()
    dev = torch.device("cuda", torch.cuda.current_device())
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    comps = [rc._completion(lib, dev, dev, s.cuda_stream) for s in streams]
    hops = 8
    srcs = [[torch.randint(-100, 100, (1 << 21,), generator=gen,
                           device="cuda", dtype=torch.int16)
             for _ in range(hops)] for _ in streams]
    seen = [[] for _ in streams]
    torch.cuda.synchronize()
    for h in range(hops):
        for k, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                dst = torch.zeros_like(srcs[k][h])
                rc._flagged_hop(lib, srcs[k][h], dst, comps[k], stream)
                seen[k].append(dst.clone())  # queued after the hop's wait
    torch.cuda.synchronize()
    rc.check_remote_copies()
    for k in range(len(streams)):
        for h in range(hops):
            assert torch.equal(seen[k][h], srcs[k][h]), (k, h)
    keys = {(dev.index, dev.index, s.cuda_stream) for s in streams}
    assert keys <= set(rc._REG.pairs)
    assert all(rc._REG.pairs[key].epoch >= hops for key in keys)


def _chip_smoke():
    """``chip_smoke.py`` as a module: its tables and checks serve the
    script and the tests alike.  Imported by name, with the repository's
    root on the path, so that a stage actor's process can import its
    class from it."""
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


def _edge_counts(stage, sms):
    """``chip_smoke.py``'s ``k4_edge_counts``: byte counts around every
    edge of K4's design."""
    return _chip_smoke().k4_edge_counts(stage, sms)


def _cuda_kernels(fn):
    """The names of the device kernels one call of ``fn`` ran, by
    ``chip_smoke.device_events`` (a profiler window held open around the
    call, so that no kernel falls outside it)."""
    return [e.name for e in _chip_smoke().device_events(fn)]


@pytest.mark.gpu
def test_profiler_windows_keep_every_kernel_on_card():
    """Every one of 100 profiler windows opened as ``chip_smoke.py`` opens
    them (``device_events``: held open ``PROFILE_PAD_S`` either side of
    the calls) records all five launches of a short kernel; without the
    pad the profiler drops, now and then, kernels its clock moves out of
    the window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the profiler traces the card")
    smoke = _chip_smoke()
    assert smoke.profiler_window_losses(100, smoke.PROFILE_PAD_S) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("edge", [
    "0", "1", "15", "16", "17", "stage-16", "stage", "stage+16",
    "2stage-16", "2stage", "2stage+16", "sms*stage-16", "sms*stage+16",
    "16MiB+3"])
def test_remote_copy_edges_on_card(edge):
    """K4 bit-exact against ``copy_`` at a byte count on an edge of its
    design (no whole vector; one stage, past which the grid splits; two
    stages; every SM busy; the main path with a tail), the 64 bytes
    either side of ``dst`` untouched, in exactly one launch, which the
    profiler names ``remote_copy_bulk_kernel``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 has no CPU or interpret mode")
    from ray_tpu_torch.ops.cuda import remote_copy as rc

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    nbytes = _edge_counts(rc.STAGE_BYTES, sms)[edge]
    gen = torch.Generator(device="cuda").manual_seed(nbytes)
    src = torch.randint(0, 256, (nbytes,), generator=gen, device="cuda",
                        dtype=torch.uint8)
    buf = torch.full((nbytes + 128,), 0xA5, dtype=torch.uint8,
                     device="cuda")
    dst = buf[64:64 + nbytes]
    want = torch.full_like(dst, 0xA5)
    want.copy_(src)
    before = rc.remote_copy.launches
    names = _cuda_kernels(lambda: rc.remote_copy(src, dst))
    assert rc.remote_copy.launches == before + 1
    assert len(names) == 1 and "remote_copy_bulk_kernel" in names[0], names
    assert torch.equal(dst, want)
    assert bool((buf[:64] == 0xA5).all()) and bool((buf[64 + nbytes:]
                                                     == 0xA5).all())


@pytest.mark.gpu
def test_remote_copy_peer_completion_across_streams():
    """The peer completion forced on one card through the private
    launcher: each 16 MiB hop's copy, with its flag, on stream A; its wait
    and a consumer that clones ``dst`` on stream B; 64 hops over rotating
    buffers, each clone bit-exact.  A flag that became visible before the
    bulk stores' bytes (a missing or misplaced proxy fence) shows here as
    a clone of the buffer's previous contents."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 has no CPU or interpret mode")
    from ray_tpu_torch.ops.cuda import remote_copy as rc

    lib = rc._lib()
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device="cuda").manual_seed(4)
    srcs = [torch.randint(-2 ** 15, 2 ** 15 - 1, (1 << 23,), generator=gen,
                          device="cuda", dtype=torch.int16)
            for _ in range(5)]
    dsts = [torch.zeros_like(srcs[0]) for _ in range(4)]
    a, b = torch.cuda.Stream(), torch.cuda.Stream()
    comp = rc._Completion(dev, dev, a.cuda_stream)
    freed, seen = [None] * len(dsts), []
    torch.cuda.synchronize()
    for h in range(64):
        k = h % len(dsts)
        with torch.cuda.stream(a):
            if freed[k] is not None:
                a.wait_event(freed[k])  # the clone of k's last hop is done
            rc._flagged_hop(lib, srcs[h % 5], dsts[k], comp, b)
        with torch.cuda.stream(b):
            seen.append(dsts[k].clone())
            freed[k] = b.record_event()
    torch.cuda.synchronize()
    assert int(comp.words[2]) == 0 and comp.epoch == 64
    for h, got in enumerate(seen):
        assert torch.equal(got, srcs[h % 5]), h


@pytest.mark.gpu
def test_remote_copy_same_card_needs_no_completion():
    """A hop within one card is the copy alone: no wait kernel, no
    completion entry, and later work on the stream sees the bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 has no CPU or interpret mode")
    from ray_tpu_torch.ops.cuda import remote_copy as rc

    src = torch.arange(1 << 20, dtype=torch.int32, device="cuda")
    dst = torch.empty_like(src)
    keys = set(rc._REG.pairs)
    names = _cuda_kernels(lambda: (rc.remote_copy(src, dst),
                                   dst.add_(1)))
    assert set(rc._REG.pairs) == keys
    assert not [n for n in names if "remote_wait_kernel" in n], names
    assert len([n for n in names if "remote_copy_bulk_kernel" in n]) == 1
    assert torch.equal(dst, src + 1)


@pytest.mark.gpu
def test_channel_read_value_lands_on_card():
    """With no device asked for, a tensor read from a channel lands on the
    card, as at every entry point of the port."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the default landing is the card")
    from ray_tpu_torch.experimental.channel import Channel

    ch = Channel(buffer_size=1 << 20)
    rd = Channel(ch.name, buffer_size=ch.buffer_size,
                 _create=False).set_reader_slot(0)
    try:
        x = torch.arange(4096, device="cuda", dtype=torch.bfloat16)
        ch.write_value({"x": x}, timeout=5)
        got = rd.read_value(timeout=5)["x"]
        assert got.device == torch.device("cuda", 0)
        assert torch.equal(got, x)
        ch.write_value({"x": x}, timeout=5)
        assert rd.read_value(timeout=5, device="cpu")["x"].device.type \
            == "cpu"
    finally:
        rd.detach()
        ch.destroy()


@pytest.mark.gpu
@pytest.mark.parametrize("check", ["spec_engine", "chunked_prefill",
                                   "int8_folded", "generate_speculative",
                                   "disagg_handoff"])
def test_serving_options_exact_in_fp32_on_card(check):
    """``chip_smoke.py``'s ``small_reference`` checks of the serving
    options on the small fp32 model, each raising on a mismatch: the
    speculative engine's tokens equal the plain engine's, chunked prefill
    equals unchunked, the int8 folded attend is within 2e-2 of eager
    dequantization, ``generate(speculative=4)`` equals greedy
    ``generate``, and the disaggregated hand-off over a device-tier edge
    equals the colocated engine, each landed tensor bit-equal to its
    export and no frame degraded.  (bf16 is not token-exact between GEMM
    shapes, so these hold in fp32.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the check runs the port's serving "
                    "paths on the card")
    smoke = _chip_smoke()
    cfg, params = smoke.small_model("cuda")
    smoke.SERVING_OPTION_CHECKS[check](cfg, params, "cuda")


@pytest.mark.gpu
def test_moe_forward_and_train_steps_match_cpu_on_card():
    """``chip_smoke.py``'s small fp32 MoE (head_dim 64, 4 experts, top-2,
    s=300, flash attention) on the card against the plain path on the
    CPU, raising on a mismatch: the forward's logits and aux, then two
    trainer steps (the first runs at lr 0, so the second is the first
    that moves the params), with K1 once per layer in the forward and
    K1/K2/K3 twice/once/once per layer per step under the full remat."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the MoE's attention runs K1-K3 on "
                    "the card")
    out = _chip_smoke().small_moe_reference("cuda", steps=2)
    assert out["forward_k1_launches"] == 2


@pytest.mark.gpu
def test_mesh_trainer_steps_match_cpu_on_card():
    """``chip_smoke.py``'s small fp32 Llama (head_dim 64, s=300, flash
    attention under ``save_attn``) through a world-1 NCCL mesh (the
    ``fsdp`` preset: the params and AdamW moments are DTensors) for three
    trainer steps on the card, against the same steps through the plain
    versions on the CPU with no mesh, raising on a mismatch; K1, K2 and
    K3 launch once per layer per step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mesh's attention runs K1-K3 "
                    "on the card over NCCL")
    out = _chip_smoke().small_mesh_reference("cuda", steps=3)
    assert out["train_k1_k2_k3_launches"] == [6, 6, 6]


@pytest.mark.gpu
def test_mesh_engine_matches_plain_engine_on_card():
    """``LLMEngine(mesh=...)`` through a world-1 NCCL mesh (``tp=1``: the
    weights and pool DTensors, the steps on their local tensors) on the
    tiny bf16 model gives the plain engine's greedy tokens, with a
    prefix hit and a preemption on both."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mesh engine runs over NCCL on "
                    "the card")
    from ray_tpu_torch.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import LlamaConfig, llama_init
    from ray_tpu_torch.parallel import MeshConfig, create_mesh

    cfg = LlamaConfig.tiny(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    params = llama_init(cfg, seed=3, device="cuda")
    shared = list(range(40, 52))
    prompts = [shared + [7, 9, 11], shared + [200, 3], list(range(60, 83)),
               [5, 9] * 6]
    kw = dict(batch_slots=3, max_len=64, block_size=4, num_blocks=14,
              seed=0)
    sp = SamplingParams(temperature=0.0, max_tokens=20)
    plain = LLMEngine(cfg, params, **kw)
    want = [o.token_ids for o in plain.generate(prompts, sp)]
    mesh = create_mesh(MeshConfig(dp=1, tp=1))
    eng = LLMEngine(cfg, params, mesh=mesh, **kw)
    got = [o.token_ids for o in eng.generate(prompts, sp)]
    assert got == want
    assert all(len(t) == 20 for t in got)
    assert eng.stats()["prefix_cache"] == plain.stats()["prefix_cache"]
    assert eng.stats()["prefix_cache"]["preemptions"] >= 1
    assert type(eng.pool["k"]).__name__ == "DTensor"
    eng.blocks.assert_integrity()


@pytest.mark.gpu
def test_moe_router_ties_on_card():
    """With an all-zero router every probability is 1/E and, as
    ``jax.lax.top_k`` does, the port routes every token to experts 0 and
    1 on CUDA too (``torch.topk`` promises no order among equal values);
    the top-1 share is then all expert 0, so the aux is E * 1/E = 1.  On
    values with many ties the CUDA pick equals the CPU's, which
    ``test_torch_moe.py`` holds to JAX's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tie order of CUDA's sort")
    from ray_tpu_torch.models import moe

    cfg = moe.MoEConfig.tiny_moe(dtype=torch.float32)
    lp = {k: v[0] for k, v in moe.moe_init(cfg, device="cuda")[
        "layers"].items()}
    lp["w_router"].zero_()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(2, 300, cfg.hidden_size, generator=gen, device="cuda")
    probs = torch.softmax(x @ lp["w_router"], dim=-1)
    idx = moe.top_k(probs, cfg.experts_per_token)[1]
    assert bool((idx == torch.tensor([0, 1], device="cuda")).all())
    out, aux = moe.moe_block(x, lp, cfg)
    assert float(aux) == 1.0 and bool(torch.isfinite(out).all())
    levels = torch.randint(0, 3, (4096, 8), generator=gen,
                           device="cuda").float()
    for k in (1, 2, 3):
        assert torch.equal(moe.top_k(levels, k)[1].cpu(),
                           moe.top_k(levels.cpu(), k)[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swiglu_op_autograd_on_card(dtype):
    """The op ``ray_tpu_torch::swiglu`` on CUDA: its output and, through
    its registered backward, its grads bit-equal to autograd through the
    function it wraps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the op's CUDA arithmetic")
    from ray_tpu_torch.ops import layers

    gen = torch.Generator(device="cuda").manual_seed(1)
    gate, up, grad = (torch.randn(2, 300, 512, generator=gen, device="cuda")
                      .mul(scale).to(dtype) for scale in (4.0, 1.0, 1.0))
    outs = []
    for fn in (layers.swiglu, layers.swiglu_op):
        g, u = gate.clone().requires_grad_(), up.clone().requires_grad_()
        out = fn(g, u)
        out.backward(grad)
        outs.append((out.detach(), g.grad, u.grad))
    for a, b in zip(*outs):
        assert a.dtype == dtype and a.is_cuda and torch.equal(a, b)


def _image_dataset(batches, batch, seed=4, size=64):
    """``batches`` blocks of ``batch`` uint8 images and int64 labels."""
    import numpy as np

    import ray_tpu_torch.data as td

    rng = np.random.default_rng(seed)
    blocks = [{"images": rng.integers(0, 256, (batch, size, size, 3),
                                      dtype=np.uint8),
               "labels": rng.integers(0, 1000, batch).astype(np.int64)}
              for _ in range(batches)]
    return td.from_blocks(blocks), blocks


@pytest.mark.gpu
@pytest.mark.parametrize("prefetch", [0, 2])
def test_iter_torch_batches_lands_host_rows_on_card(prefetch):
    """``device=None`` lands on the card; every batch equals its host rows
    cast on the card, and the copies ran from page-locked staging."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ds, blocks = _image_dataset(6, 16)
    it = ds.iterator()
    got = list(it.iter_torch_batches(
        batch_size=16, dtypes={"images": torch.float32},
        prefetch_batches=prefetch))
    assert len(got) == len(blocks)
    for b, host in zip(got, blocks):
        assert b["images"].is_cuda and b["images"].dtype == torch.float32
        assert torch.equal(b["images"], torch.from_numpy(host["images"]).to(
            "cuda", torch.float32))
        assert torch.equal(b["labels"], torch.from_numpy(host["labels"]).cuda())
    stats = it.ingest_stats.to_dict()
    assert stats["pinned_bytes"] > 0
    assert stats["h2d_batches"] == len(blocks)
    assert stats["h2d_bytes"] == sum(
        h["images"].size * 4 + h["labels"].nbytes for h in blocks)


@pytest.mark.gpu
def test_iter_torch_batches_stream_order_with_three_batches_held():
    """Three landed batches held at once while the stager reuses its two
    slots, each read by queued work on the consumer's stream: the event
    wait and ``record_stream`` keep every batch intact under load."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    import ray_tpu_torch.data as td

    rows, cols = 64, 1 << 16  # 16 MiB of fp32 per batch
    host = np.arange(8 * rows * cols, dtype=np.int32).reshape(8 * rows, cols)
    it = td.from_numpy(host).iter_torch_batches(
        batch_size=rows, dtypes={"data": torch.float32}, prefetch_batches=2)
    held, sums = [], []
    w = torch.randn(cols, 256, device="cuda")
    for i, b in enumerate(it):
        # queue a long read of the batch on the consumer's stream
        for _ in range(20):
            y = b["data"] @ w
        sums.append(y.sum())
        held.append(b)
        if len(held) > 3:
            held.pop(0)
        for j, h in enumerate(held):
            start = (i - len(held) + 1 + j) * rows
            want = torch.from_numpy(host[start:start + rows]).to(
                "cuda", torch.float32)
            assert torch.equal(h["data"], want)
    torch.cuda.synchronize()
    assert len(sums) == 8 and all(torch.isfinite(s) for s in sums)


@pytest.mark.gpu
def test_to_tensors_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ds, blocks = _image_dataset(2, 8, size=16)
    out = ds.to_tensors()
    assert out["images"].is_cuda and out["images"].dtype == torch.uint8
    import numpy as np

    want = np.concatenate([b["images"] for b in blocks])
    assert torch.equal(out["images"].cpu(), torch.from_numpy(want))
    assert out["labels"].is_cuda


@pytest.mark.gpu
def test_llm_replica_on_card_matches_cpu_engine():
    """A tiny-config LLMServer replica process on ``cuda:0`` (its weights
    the CPU engine's, sent to it on the card) answers the texts the tiny
    engine gives on the CPU, request by request (fp32, greedy)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.llm.serving import build_llm_deployment
    from ray_tpu_torch.models.llama import LlamaConfig, llama_init

    def tree_to(tree, device):
        if isinstance(tree, dict):
            return {k: tree_to(v, device) for k, v in tree.items()}
        return tree.to(device)

    cfg = LlamaConfig.tiny()
    params = llama_init(cfg, 0, "cpu")
    kw = {"batch_slots": 4, "max_len": 128}
    prompts = ["the quick brown fox", "hello", "a b c d e f g h"]
    eng = LLMEngine(cfg, params, device="cpu", **kw)
    sp = SamplingParams(temperature=0.0, max_tokens=8,
                        stop_token_id=eng.tokenizer.eos_id)
    want = [eng.generate([p], sp)[0] for p in prompts]
    try:
        handle = serve.run(build_llm_deployment(
            {"cfg": cfg, "params": tree_to(params, "cuda:0"), **kw}),
            name="gpu", route_prefix="/gpu")
        got = [handle.remote({"prompt": p, "max_tokens": 8,
                              "temperature": 0.0}).result(timeout=120)
               for p in prompts]
        stats = handle.stats.remote().result(timeout=30)
    finally:
        serve.shutdown()
    assert [g["generated_text"] for g in got] == [w.text for w in want]
    assert [g["num_generated_tokens"] for g in got] == \
        [len(w.token_ids) for w in want]
    assert stats["engine_steps"] > 0 and stats["timing"]["decode_tokens"] > 0


@pytest.mark.gpu
def test_rl_ppo_update_matches_cpu_on_card():
    """``chip_smoke.py``'s ``rl_ppo`` check at a small size (64 envs x 16
    steps): one ``PPOLearner._update_with_perms`` and one
    ``compute_gae`` on the card against the CPU from the same
    parameters, batch and permutations (params atol 1e-4, GAE 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the check compares the card with "
                    "the CPU")
    out = _chip_smoke().rl_small_ppo_check("cuda")
    assert out["update_params_max_abs_err"] <= 1e-4
    assert out["gae_max_abs_err"] <= 1e-5


@pytest.mark.gpu
def test_rl_families_update_match_cpu_on_card():
    """``chip_smoke.py``'s ``rl_families`` at the card tests' sizes: DQN,
    SAC, IMPALA, APPO, CQL, BC, MARWIL and DreamerV3 each take two
    iterations on the card (losses finite) and one update there against
    the CPU from the same inputs (Dreamer: the world-model loss and
    update with the same latent noise).  No gymnasium."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the check compares the card with "
                    "the CPU")
    out = _chip_smoke().rl_families("cuda", small=True, iters=2)
    assert set(out) == {"dqn", "sac", "impala", "appo", "cql", "bc",
                        "marwil", "dreamer"}
    assert all(f["finite"] for f in out.values())
    assert all(f["k1_k4_launches"] == [0, 0, 0, 0] for f in out.values())


@pytest.mark.gpu
def test_cuda_bf16_tree_through_snapshot_and_reassemble():
    """A bf16 tree on the card through ``snapshot_shards`` (one page-locked
    blob per writer) and ``reassemble``: every leaf bit-equal, at world 1
    and split over two writers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the snapshot's D2H into "
                    "page-locked memory")
    from ray_tpu_torch.train import checkpoint_async as ca

    gen = torch.Generator(device="cuda").manual_seed(0)
    tree = {"w": torch.randn(37, 64, generator=gen, device="cuda").bfloat16(),
            "norm": torch.randn(64, generator=gen, device="cuda").bfloat16(),
            "step": 5}
    for world in (1, 2):
        blobs = {r: ca.snapshot_shards(tree, r, world, run="g", index=1)
                 for r in range(world)}
        assert all(b.is_pinned() for b in blobs.values())
        out, _ = ca.reassemble(blobs)
        for k in ("w", "norm"):
            assert out[k].dtype == torch.bfloat16
            assert torch.equal(out[k].view(torch.int16),
                               tree[k].cpu().view(torch.int16))
        assert out["step"] == 5


@pytest.mark.gpu
def test_params_digest_of_a_cuda_tree_equals_its_cpu_copy():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ray_tpu_torch.rl.weight_sync import params_digest

    gen = torch.Generator(device="cuda").manual_seed(1)
    tree = {"a": torch.randn(300, 17, generator=gen,
                             device="cuda").bfloat16(),
            "b": [torch.randn(5, generator=gen, device="cuda")]}
    host = {"a": tree["a"].cpu(), "b": [tree["b"][0].cpu()]}
    assert params_digest(tree, 3, 1) == params_digest(host, 3, 1)


@pytest.mark.gpu
def test_save_is_not_reached_by_the_next_in_place_step():
    """``AsyncCheckpointer.save`` returns a finished host copy: an in-place
    optimizer step on the card right after it (queued on the same
    stream, no synchronize between) does not reach the snapshot."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ray_tpu_torch.train.checkpoint_async import (AsyncCheckpointer,
                                                      reassemble)

    from ray_tpu_torch.train import checkpoint_async as ca

    p = torch.zeros(1 << 22, device="cuda")
    ck = AsyncCheckpointer(None, "inplace", 0, 1, publish_status=False)
    ptrs = []
    try:
        # five saves: the fourth and fifth into reused page-locked buffers
        for i in range(5):
            p.fill_(float(i))
            h = ck.save({"p": p})
            ptrs.append(ca._local_get("inplace", h.index, 0).data_ptr())
            big = torch.randn(4096, 4096, device="cuda")
            for _ in range(4):  # keep the stream busy, then write in place
                big = big @ big
            p.add_(100.0)
            out, _ = reassemble({0: ca._local_get("inplace", h.index, 0)})
            assert torch.equal(out["p"], torch.full_like(out["p"],
                                                         float(i)))
        torch.cuda.synchronize()
        assert float(p[0]) == 104.0
        assert ptrs[3:] == ptrs[:2]
    finally:
        ck.close()


@pytest.mark.gpu
def test_weight_publish_from_the_card_into_registered_slots():
    """A bf16 tree on the card published five times (``keep=2``: the
    fourth and fifth into reused, page-locked payload slots) lands in a
    CPU subscriber bit-equal each time, its digest equal to the card's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the DMA into a registered slot")
    from ray_tpu_torch._private import kv as kv_mod
    from ray_tpu_torch.rl.weight_sync import (WeightPublisher,
                                              WeightSubscriber,
                                              params_digest)

    store = kv_mod.host()
    gen = torch.Generator(device="cuda").manual_seed(2)
    tree = {"w": torch.randn(513, 64, generator=gen,
                             device="cuda").bfloat16(),
            "b": [torch.randn(7, generator=gen, device="cuda")]}
    pub = WeightPublisher("gpu-slots", resume=False, keep=2, kv=store)
    sub = WeightSubscriber("gpu-slots", device="cpu", kv=store)
    try:
        for i in range(5):
            with torch.no_grad():
                tree["w"].add_(1.0)
            ver = pub.publish(tree)
            assert pub.last_publish["new_slot"] == (i < 3)
            assert sub.poll(timeout_s=5.0)
            got, v = sub.current()
            assert v == ver
            assert torch.equal(got["w"].view(torch.int16),
                               tree["w"].cpu().view(torch.int16))
            assert torch.equal(got["b"][0], tree["b"][0].cpu())
            assert params_digest(got, v.version, v.epoch) == \
                params_digest(tree, v.version, v.epoch)
    finally:
        pub.close()


@pytest.mark.gpu
def test_compiled_dag_stages_on_card_bit_equal_one_process():
    """A tiny bf16 Llama (4 layers, head_dim 64, K1 on the card) as two
    stage processes on ``cuda:0`` under one compiled DAG: the last
    position's logits and every argmax token equal one process's
    ``llama_apply`` bit for bit, every edge on the device tier with no
    degraded frame, and K1 once per layer per execution in each stage."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: stage processes on the card")
    from ray_tpu_torch import actor
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.models.llama import LlamaConfig, llama_apply

    smoke = _chip_smoke()
    cfg = LlamaConfig.tiny(num_layers=4, hidden_size=256, num_heads=4,
                           num_kv_heads=4, max_seq_len=512,
                           dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    params = smoke.stage_params(cfg, 0, 4, seed=0, device="cuda")
    stages, _, _ = smoke.start_stages(
        smoke.ForwardStage, [((cfg, 0, 2), {"seed": 0}),
                             ((cfg, 2, 4), {"seed": 0})])
    try:
        with InputNode() as inp:
            dag = stages[1].forward.bind(stages[0].forward.bind(inp))
        compiled = dag.experimental_compile()
        try:
            gen = torch.Generator(device="cuda").manual_seed(1)
            runs = 3
            for _ in range(runs):
                tokens = torch.randint(0, cfg.vocab_size, (1, 300),
                                       generator=gen, device="cuda")
                out = compiled.execute(tokens).get(timeout=120)
                want = llama_apply(params, tokens, cfg)
                assert torch.equal(out["last_logits"], want[:, -1])
                assert torch.equal(out["tokens"], want.argmax(-1))
            stats = compiled.stats()
            launches = actor.get([s._remote_call.remote(
                smoke.stage_launches) for s in stages], timeout=60)
        finally:
            compiled.teardown()
    finally:
        for s in stages:
            actor.kill(s)
    assert set(stats["channel_transport"].values()) == {"B-device"}
    assert smoke.dag_degraded(stats) == 0
    assert [c[0] for c in launches] == [2 * runs, 2 * runs]


@pytest.mark.gpu
def test_killed_stage_on_card_surfaces_actor_died():
    """A stage process on the card killed while it computes: the pending
    execution's ``get`` raises ``ActorDiedError`` naming the stage, and
    ``teardown`` returns promptly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: stage processes on the card")
    import time

    from ray_tpu_torch import actor
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.exceptions import ActorDiedError
    from ray_tpu_torch.models.llama import LlamaConfig

    smoke = _chip_smoke()
    cfg = LlamaConfig.tiny(num_layers=2, dtype=torch.bfloat16,
                           param_dtype=torch.bfloat16)
    stages, _, _ = smoke.start_stages(
        smoke.ForwardStage, [((cfg, 0, 1), {"seed": 0}),
                             ((cfg, 1, 2), {"seed": 0})])
    try:
        with InputNode() as inp:
            dag = stages[1].forward.bind(stages[0].forward.bind(inp))
        compiled = dag.experimental_compile()
        tokens = torch.zeros(1, 16, dtype=torch.long, device="cuda")
        compiled.execute(tokens).get(timeout=120)
        actor.kill(stages[1])
        ref = compiled.execute(tokens)
        with pytest.raises(ActorDiedError, match="ForwardStage"):
            ref.get(timeout=60)
        t0 = time.monotonic()
        compiled.teardown(timeout=10)
        assert time.monotonic() - t0 < 8.0
    finally:
        for s in stages:
            actor.kill(s)


@pytest.mark.gpu
def test_mesh_group_on_the_cards_present():
    """The single-process group over every card present (one or more):
    each op against its plain version on integer-valued fp32 (exact) and
    bf16 rows (bit-exact), and ``permute`` one K4 launch per pair,
    bit-exact, zeros where no pair sends."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: permute is K4, which has no CPU "
                    "or interpret mode, and the other ops are NCCL's")
    from ray_tpu_torch.ops.cuda.remote_copy import remote_copy
    from ray_tpu_torch.util.collective.collective_group import (
        mesh_group as mg)
    from ray_tpu_torch.util.collective.types import ReduceOp

    n = torch.cuda.device_count()
    group = mg.CudaMeshGroup(n)
    devs = [torch.device("cuda", i) for i in range(n)]
    assert group.devices == devs
    gen = torch.Generator().manual_seed(3)
    ints = [torch.randint(-3, 4, (n, 1000), generator=gen).float().to(d)
            for d in devs]
    rows = [torch.randn(4, 333, generator=gen).bfloat16().to(d)
            for d in devs]

    def same(got, want):
        assert [t.device for t in got] == devs
        for g, w in zip(got, want):
            assert torch.equal(g.cpu().view(torch.uint8),
                               w.cpu().view(torch.uint8))

    for op in ("sum", "max", "min", "product"):
        same(group.allreduce(ints, ReduceOp(op)),
             [mg.allreduce_plain(ints, ReduceOp(op))] * n)
    same(group.broadcast(rows, n - 1), mg.broadcast_plain(rows, n - 1))
    same(group.allgather(rows), [mg.allgather_plain(rows)] * n)
    same(group.reducescatter(ints), mg.reducescatter_plain(ints))
    group.barrier()
    perms = [[(i, (i + 1) % n) for i in range(n)], [(0, n - 1)]]
    before = remote_copy.launches
    for perm in perms:
        got = group.permute(rows, perm)
        same(got, mg.permute_plain(rows, perm))
    assert remote_copy.launches - before == sum(len(p) for p in perms)
    with pytest.raises(ValueError, match="lies on"):
        group.allreduce([t.to(devs[0]) for t in ints[::-1]] if n > 1
                        else [ints[0].cpu()])
