#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``env``: the card (``nvidia-smi`` name and power limit), torch, CUDA
   and nvcc versions, and the build of every CUDA kernel from the
   repository's own sources (all nvcc processes started together).
2. ``kernel``: each kernel against its plain PyTorch version on the card,
   one line per case, with the kernel's, the plain version's and one
   library call's time, and the least time the card could take.
3. ``small_reference``: small fp32 models on the card against a plain
   reference: the forward through K1 against the reference attention, and
   greedy ``LLMEngine`` output against full-recompute argmax.
4. ``forward``: ``llama_apply`` at full Llama-2-7B width and depth (bf16
   weights from a seed, b=1, s=2048); K1 must launch once per layer.
5. ``serve``: ``LLMEngine`` on the same model answers five ~200-token
   requests, two sharing a 64-token prefix (greedy, 32 new tokens).

Then the ``kernels`` line (every ported kernel with its launches on the
main path), the ``nvidia-smi`` line and, last, the result line
``{"ok": true, "device": {...}}``.  Any failure raises: the traceback is
printed, the exit code is non-zero and no result line is printed.  Without
CUDA, or without the package beside it, the script exits non-zero at once.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

SEQ = 2048          # forward phase sequence length (b = 1)
SERVE_SLOTS = 4
SERVE_MAX_LEN = 1024
SERVE_BLOCK = 16
SERVE_NEW_TOKENS = 32
# published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# fp32 on the CUDA cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# (name, b, s, h, kv_h, d, dtype, causal, atol/rtol on O, atol on lse)
# bf16: O is rounded to bf16 and P is cast to bf16 before PV, so 2e-2;
# lse is fp32 on both sides, summed in another order, so 1e-3.
# fp32: every step in fp32, sums over <= 2048 terms in another order.
K1_CASES = [
    ("main_path", 1, SEQ, 32, 32, 128, "bfloat16", True, 2e-2, 1e-3),
    ("gqa_ragged", 1, 1000, 32, 8, 128, "bfloat16", True, 2e-2, 1e-3),
    ("non_causal_d64", 2, 512, 16, 16, 64, "bfloat16", False, 2e-2, 1e-3),
    ("fp32", 1, 384, 8, 2, 128, "float32", True, 1e-4, 1e-4),
    ("fp32_d64_ragged", 1, 333, 4, 4, 64, "float32", True, 1e-4, 1e-4),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=120).stdout.strip()


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` launches after a warm-up,
    by CUDA events (inputs stay warm in L2 where they fit)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(b, sq, sk, h, kv_h, d, dtype, causal):
    """Least time for the attention function: each input read once, each
    output written once, against 4*d FLOPs per visible (q, k) pair."""
    esize = 2 if dtype == "bfloat16" else 4
    if causal:
        pairs = sum(min(i + 1, sk) for i in range(sq))
    else:
        pairs = sq * sk
    flops = 4.0 * d * pairs * b * h
    nbytes = esize * (2 * b * sq * h * d + 2 * b * sk * kv_h * d) \
        + 4 * b * h * sq
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


def phase_env():
    import torch

    from ray_tpu_torch.ops.cuda import _build

    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    nvcc = run([_build.nvcc_path(), "--version"]).splitlines()[-1]
    t0 = time.perf_counter()
    log = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in entry["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, entry in log.items()}
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "build_s": build_s, "ptxas": ptxas})
    return smi


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops.cuda.flash_attention import (flash_attention_fwd,
                                                        flash_attention_plain)

    results = {}
    for (name, b, s, h, kv_h, d, dtype, causal, tol_o,
         tol_lse) in K1_CASES:
        gen = torch.Generator(device="cuda").manual_seed(len(results))
        dt = getattr(torch, dtype)
        q = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dt)
        k = torch.randn(b, s, kv_h, d, generator=gen, device="cuda").to(dt)
        v = torch.randn(b, s, kv_h, d, generator=gen, device="cuda").to(dt)
        out, lse = flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        pout, plse = flash_attention_plain(q, k, v, causal=causal)
        err_o = (out.float() - pout.float()).abs()
        err_lse = float((lse - plse).abs().max())
        bad_o = err_o > tol_o + tol_o * pout.float().abs()
        if bool(bad_o.any()) or err_lse > tol_lse or \
                not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(
                f"K1 {name}: disagrees with its plain version: max |dO| "
                f"{float(err_o.max())} ({int(bad_o.sum())} elements over "
                f"atol=rtol={tol_o}), max |dlse| {err_lse} (atol {tol_lse})")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        gqa = {"enable_gqa": True} if h != kv_h else {}
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, causal=causal))
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v,
                                                         causal=causal), 5)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, **gqa))
        bound_ms, bound_by = attention_bound(b, s, s, h, kv_h, d, dtype,
                                             causal)
        row = {"phase": "kernel", "kernel": "K1 flash_fwd", "case": name,
               "shape": {"b": b, "s": s, "h": h, "kv_h": kv_h, "d": d},
               "dtype": dtype, "causal": causal,
               "max_abs_err": float(err_o.max()), "lse_max_abs_err": err_lse,
               "atol_rtol": tol_o, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by}
        emit(row)
        results[name] = row
        del q, k, v, qt, kt, vt, out, lse, pout, plse, err_o
        torch.cuda.empty_cache()
    return results


def phase_small_reference(device="cuda"):
    """Small fp32 models on the card against a plain reference: logits
    through K1 against the reference attention (fp32 sums in another
    order: 1e-4), and greedy engine tokens against full-recompute argmax
    (token-exact)."""
    import torch

    from ray_tpu_torch.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import (LlamaConfig, llama_apply,
                                            llama_init)

    cfg = LlamaConfig.tiny(hidden_size=256, num_heads=4, num_kv_heads=2,
                           max_seq_len=512)  # head_dim 64
    params = llama_init(cfg, seed=1, device=device)
    gen = torch.Generator(device=device).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 300), generator=gen,
                           device=device)
    flash = llama_apply(params, tokens,
                        dataclasses.replace(cfg, attention_impl="flash"))
    ref = llama_apply(params, tokens,
                      dataclasses.replace(cfg, attention_impl="ref"))
    fwd_err = float((flash - ref).abs().max())
    if not fwd_err <= 1e-4:
        raise AssertionError(f"forward through K1 vs reference: max |d| "
                             f"{fwd_err} > 1e-4")
    eng = LLMEngine(cfg, params, batch_slots=2, max_len=128, block_size=8,
                    device=device)
    prompts = [[5, 9, 3, 7, 11, 13, 2, 4, 6, 8, 10], [7, 1, 2], [42]]
    outs = eng.generate(prompts, SamplingParams(temperature=0.0,
                                                max_tokens=6))
    for p, o in zip(prompts, outs):
        seq = list(p)
        for tok in o.token_ids:
            logits = llama_apply(params, torch.tensor([seq], device=device),
                                 cfg)
            if int(logits[0, -1].argmax()) != tok:
                raise AssertionError(f"engine token {tok} != recompute "
                                     f"argmax after {seq}")
            seq.append(tok)
    eng.blocks.assert_integrity()
    return {"forward_k1_vs_ref_max_abs": fwd_err,
            "engine_tokens_checked": sum(len(o.token_ids) for o in outs)}


def phase_forward(cfg, params, device="cuda"):
    """One ``llama_apply`` of b=1, s=SEQ random tokens after a warm-up
    forward; returns timing, K1 launches in the timed forward and a
    comparison with the reference-attention forward on the same tokens."""
    import torch

    from ray_tpu_torch.models.llama import llama_apply
    from ray_tpu_torch.ops.cuda.flash_attention import flash_attention_fwd

    gen = torch.Generator(device=device).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (1, SEQ), generator=gen,
                           device=device)
    llama_apply(params, tokens, cfg)  # warm-up: library handles, allocator
    torch.cuda.synchronize()
    flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    logits = llama_apply(params, tokens, cfg)
    torch.cuda.synchronize()
    forward_ms = 1e3 * (time.perf_counter() - t0)
    launches = flash_attention_fwd.launches
    if tuple(logits.shape) != (1, SEQ, cfg.vocab_size) \
            or logits.dtype != torch.float32 \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"forward logits: shape {tuple(logits.shape)}, "
                             f"dtype {logits.dtype}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    # accuracy: the bf16 forward through K1 and the bf16 forward through
    # the reference attention, each against an fp32-activation forward of
    # the same weights (reference attention)
    ref = llama_apply(params, tokens,
                      dataclasses.replace(cfg, attention_impl="ref"))
    f32 = llama_apply(params, tokens,
                      dataclasses.replace(cfg, attention_impl="ref",
                                          dtype=torch.float32))
    busy_ms, top = device_profile(lambda: llama_apply(params, tokens, cfg))
    err_k1 = float((logits - f32).abs().mean())
    err_ref = float((ref - f32).abs().mean())
    # the K1 path must be as close to fp32 as the reference path is: both
    # carry the same bf16 rounding (ratio 0.99 on an H100); 1.2 leaves
    # room for that noise and fails a kernel that adds error of its own
    if not err_k1 <= 1.2 * err_ref:
        raise AssertionError(f"bf16 forward through K1 is further from the "
                             f"fp32 forward ({err_k1}) than the reference "
                             f"path ({err_ref})")
    return {"forward_ms": forward_ms, "k1_launches": launches,
            "tokens": SEQ, "device_busy_ms": busy_ms,
            "top_kernels_ms": top, "logits_max_abs": float(f32.abs().max()),
            "k1_vs_fp32_mean_abs": err_k1, "ref_vs_fp32_mean_abs": err_ref,
            "k1_vs_ref_max_abs": float((logits - ref).abs().max()),
            "k1_vs_fp32_argmax_agree": _agree(logits, f32),
            "ref_vs_fp32_argmax_agree": _agree(ref, f32)}


def _agree(a, b) -> float:
    return float((a.argmax(-1) == b.argmax(-1)).float().mean())


def serve_prompts(vocab_size, seed=0):
    """Five prompts of 190-214 tokens; the first two share 64 tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shared = rng.integers(3, vocab_size, size=64).tolist()
    return [shared + rng.integers(3, vocab_size, size=n).tolist()
            for n in (136, 150)] + \
        [rng.integers(3, vocab_size, size=n).tolist()
         for n in (200, 214, 190)]


def phase_serve(cfg, params, device="cuda", max_len=SERVE_MAX_LEN):
    from ray_tpu_torch.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.ops.cuda.flash_attention import flash_attention_fwd

    eng = LLMEngine(cfg, params, batch_slots=SERVE_SLOTS, max_len=max_len,
                    block_size=SERVE_BLOCK, seed=0, device=device)
    prompts = serve_prompts(cfg.vocab_size)
    flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    outs = eng.generate(prompts, SamplingParams(
        temperature=0.0, max_tokens=SERVE_NEW_TOKENS))
    wall_s = time.perf_counter() - t0
    launches = flash_attention_fwd.launches
    for o in outs:
        if o.error is not None or len(o.token_ids) != SERVE_NEW_TOKENS \
                or not all(0 <= t < cfg.vocab_size for t in o.token_ids):
            raise AssertionError(f"request {o.request_id}: error {o.error}, "
                                 f"{len(o.token_ids)} tokens")
    stats = eng.stats()
    if stats["prefix_cache"]["prefix_hits"] < 1:
        raise AssertionError(f"no prefix hit: {stats['prefix_cache']}")
    eng.blocks.assert_integrity()
    t = stats["timing"]
    return {"requests": len(outs), "prompt_tokens": [len(p) for p in prompts],
            "new_tokens": sum(len(o.token_ids) for o in outs),
            "wall_s": wall_s, "prefill_ms": 1e3 * t["prefill_s"],
            "prefill_tokens": t["prefill_tokens"],
            "prefill_tokens_per_s": t["prefill_tokens"] / t["prefill_s"],
            "decode_tokens": t["decode_tokens"],
            "decode_tokens_per_s": t["decode_tokens"] / t["decode_s"],
            "k1_launches": launches, "prefix_cache": stats["prefix_cache"],
            "first_tokens": [o.token_ids[:4] for o in outs],
            "decode_profile": profile_decode_window(eng, cfg.vocab_size)}


def device_profile(fn):
    """Kernel time of one call of ``fn`` under ``torch.profiler``:
    ``(busy_ms, top kernels [[name, ms], ...])``, or "not measured" when
    the profiler records no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    if not by_name:
        return "not measured", []
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return sum(by_name.values()), [[n[:80], ms] for n, ms in top]


def profile_decode_window(eng, vocab_size):
    """Where a decode window's time goes: one window of ``eng.K`` steps over
    all slots under the profiler (kernel time by name), then an identical
    window without it (wall time).  The idle share is 1 - kernel time /
    unprofiled wall time."""
    import numpy as np
    import torch

    from ray_tpu_torch.llm import SamplingParams

    rng = np.random.default_rng(7)
    sp = SamplingParams(temperature=0.0, max_tokens=3 * eng.K + 1)
    for _ in range(eng.B):
        eng.submit(rng.integers(3, vocab_size, size=100).tolist(), sp)
    eng.step()  # admissions and the first window
    busy_ms, top = device_profile(eng.step)
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    while eng.has_unfinished():
        eng.step()
    return {"window_steps": eng.K, "slots": eng.B,
            "unprofiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms if top else "not measured",
            "top_kernels_ms": top}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the "
              "port on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ray_tpu_torch.models.llama import LlamaConfig, llama_init

    smi = phase_env()
    k1 = phase_kernels()
    emit({"phase": "small_reference", **phase_small_reference()})

    cfg = dataclasses.replace(LlamaConfig.llama2_7b(),
                              param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = llama_init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    fwd = phase_forward(cfg, params)
    emit({"phase": "forward", "model": "llama2_7b", "layers": cfg.num_layers,
          "depth_cut": False, "weights_gb": sum(
              t.numel() * t.element_size() for t in
              [params["embed"], params["lm_head"], params["final_norm"],
               *params["layers"].values()]) / 1e9,
          "init_s": init_s, **fwd})
    if fwd["k1_launches"] != cfg.num_layers:
        raise AssertionError(f"K1 launched {fwd['k1_launches']} times in "
                             f"the forward, expected {cfg.num_layers}")
    serve = phase_serve(cfg, params)
    emit({"phase": "serve", "model": "llama2_7b", "slots": SERVE_SLOTS,
          "max_len": SERVE_MAX_LEN, "block_size": SERVE_BLOCK, **serve,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})

    main_case = k1["main_path"]
    emit({"kernels": [{
        "name": "K1 flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/ops/cuda/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/pallas/flash_attention.py:45",
        "launches": fwd["k1_launches"],
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
