#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

(``python3 chip_smoke.py startup`` runs the ``env`` and ``startup``
phases alone.  On a machine with four or more cards the four-card
phases below can run alone, after the ``env`` phase: ``python3 chip_smoke.py mesh4`` runs
``mesh4``, ``serve_mesh4`` the ``serve`` phase it compares with and
``serve_mesh4``, ``trainer4`` ``mesh4`` and ``trainer4``; the names
combine, as in ``python3 chip_smoke.py serve_mesh4 trainer4``.  On one
card the data-plane phases run alone the same way: ``data_trainer``
runs ``train``, ``trainer`` and ``data_trainer``, ``data_vit`` runs
``vit_train`` and ``data_vit``; so do the serving front's:
``llm_server``, ``llm_disagg`` (after ``llm_server``) and
``llm_batch``; the RL stack's: ``rl_ppo``, ``rl_runners``,
``rl_multi_agent`` and ``rl_families``; and the compiled-graph DAG's:
``dag_forward`` (after ``forward``) and ``dag_pipeline`` (after
``train``).  With four cards ``dag4`` runs alone too.)

Phases, each printing one JSON line:

1. ``env``: the card (``nvidia-smi`` name and power limit), torch, CUDA
   and nvcc versions, and the build of every CUDA kernel from the
   repository's own sources (all nvcc processes started together), with
   each kernel's registers and spill bytes from ptxas; the tensor-core
   kernels must not spill.  Then how many profiler windows lost kernels
   of a short one launched in them, with the window held open
   ``PROFILE_PAD_S`` either side as every window here is, and without.
2. ``kernel``: each kernel against its plain PyTorch version on the card,
   per case one line for K1 (the flash forward) and one for K2/K3 (its
   backward), with the kernels', the plain version's and one library
   call's time, the least time the card could take, and what a kernel is
   judged by beside its time: TFLOP/s and the share of its bound.  By
   the profiler's kernel names, bf16 must run K2 and K3 on the tensor-core
   (wgmma) kernels and fp32 on the FMA kernels; for bf16, how many dq
   elements a bf16 flip of dS moved, the kernel's beside the plain
   version's (``dq_flipped_vs_exact``).  Then K4 (the remote copy) in
   rings of four ranks on one card: at the main-path payload, one
   Llama-2-7B pipeline-stage activation ([1, 2048, 4096] bf16, 16 MiB),
   shifts 1 and 3, and at odd byte counts, each bit-exact against
   ``copy_`` with one launch per hop; the main-path row names the kernel
   a hop launched (by the profiler), how the hop completes ("stream
   order" on one card) and its ring of shared memory.  Then one hop at
   each edge of the design (0 to 17 bytes, one stage, two stages, every
   SM busy, 16 MiB + 3), each bit-exact with
   one launch of the named kernel; the ``cross_stream`` line, the peer
   completion forced across two streams of one card (64 hops, each
   consumer's clone bit-exact) and timed against a bare copy; with two
   cards and peer access, the ring over NVLink, 64 flagged hops onto
   cuda:1 each consumed there bit-exact, and the hop timed, else a line
   saying why not.
3. ``small_reference``: small fp32 models on the card against a plain
   reference: the forward through K1 against the reference attention,
   greedy ``LLMEngine`` output against full-recompute argmax, the serving
   options held exact in fp32 (the speculative engine's tokens against
   the plain engine's, chunked prefill against unchunked, the int8
   folded attend against eager dequantization within 2e-2, dense
   ``generate(speculative=4)`` against greedy ``generate``, and the
   disaggregated hand-off over a device-tier edge against the colocated
   engine, each landed tensor bit-equal to its export), three
   train steps (K1/K2/K3 under ``save_attn``) against the same steps
   through the plain versions on the CPU, and a small MoE (4 experts,
   top-2) held alike: its forward, then three train steps under its full
   remat; and the three train steps again through a world-1 NCCL mesh
   (the params DTensors) against the plain path on the CPU.
3b. ``startup``: process start-up split by stage.  After one throw-away
   child that starts the worker zygote (``_private/worker_zygote.py``),
   four children bound to ``cuda:0`` start together through the zygote,
   then four with ``RAY_TPU_TORCH_USE_WORKER_ZYGOTE=0`` (cold, through
   ``spawn``).  Each stamps its entry, ``import torch``, the port's
   imports, its CUDA context, the K1 library's load and its first K1
   launch (b=1, h=8, s=256, d=128, bf16, causal), held against the plain
   attention at K1's tolerance; the parent stamps its reply.  The line
   gives each stage's median and range per start method, the zygote's
   preload, and fails unless every zygote child's parent is the zygote
   (and every cold one's this process), the zygote had one thread and no
   CUDA when it forked, and every child launched K1 once on the card.
4. ``channel``: a device-tier edge between two processes.  This process
   writes ten 16 MiB bf16 activations (and a step counter) through
   ``make_edge_transport``; a reader forked by the worker zygote on the
   same card lands each on the card with ``read_borrowed`` and sends back a
   digest of its bytes.  Both ends must negotiate the device tier from
   their own endpoint info, every frame must be a device frame, none may
   degrade, and every segment is destroyed.
5. ``ring``: ``device_ring_copy`` (the in-process device hop) moves the
   four ranks' activations around the ring, shifts 1 and 3; K4 must
   launch once per hop and the result must equal the shifted input.  The
   host's time per ring of ``device_ring_copy`` is split into its K4
   launches, its completion check and the rest, and the wait for the
   card after it.
6. ``forward``: ``llama_apply`` at full Llama-2-7B width and depth (bf16
   weights from a seed, b=1, s=2048); K1 must launch once per layer.
6b. ``dag_forward``: the same forward as a compiled DAG
   (``ray_tpu_torch.dag``) of two stage processes on the card
   (``ForwardStage`` actors: 16 layers each, each drawing only its half
   of the weights from the same seed), ``inp -> stage0.forward ->
   stage1.forward`` over 32 MiB channels; one warm-up, then eight
   executions with up to two in flight, and one alone.  The last
   position's logits and every argmax token must equal this process's
   ``llama_apply`` (bit-equal expected; a miss within K1's bf16
   tolerance), every edge must negotiate the device tier with no
   degraded frame, and K1 must launch 16 times per stage per execution,
   counted in the stage processes.  It prints the wall per execution
   beside the one-process forward, the channel wait per edge, the
   stages' start-up, build and memory.
7. ``serve``: ``LLMEngine`` on the same model answers five ~200-token
   requests, two sharing a 64-token prefix (greedy, 32 new tokens); one
   decode window is profiled (busy ms as the union over streams, idle
   share).
7b. ``serve_mesh``: the same engine and requests through a world-1 NCCL
   mesh (``tp=1``: weights and pool DTensors, the steps on their local
   tensors).  Every token must equal ``serve``'s; decode tokens/s, the
   profiled window and peak memory are printed beside ``serve``'s.
7c. ``serve_mesh4`` (only with four or more cards; else a line says
   so): four NCCL ranks, one per card, started and joined with a
   timeout, serve the same requests with Llama-2-7B at full depth on
   ``tp=4``, on ``pp=2 x tp=2`` and on ``dp=2 x pp=2`` (one card's ops on
   each stage, which shows what the pp hand-off alone changes).  The
   first-token logits must lie within twice the single-card bf16
   engine's max-abs distance from an fp32 forward of the same weights
   (the bound); every first token whose fp32 top-two margin exceeds the
   bound must equal the single card's, and any other must be one of
   fp32's top two; the first decode step's logits, over the slots whose
   first token agrees, must be no farther from fp32 than twice the
   single card's distance; it prints the greedy tokens
   equal to the single card's, each slot's and request's distance from
   fp32 and from the single card, decode tokens/s, each rank's weight and
   pool bytes and NCCL ms per decode step.
8. ``serve_options``: the engine's serving options on the same weights,
   each beside the plain engine on the same prompts: speculative decoding
   (``spec_tokens=4``) on the model's own loop (a greedy fixed point,
   found by one forward of every token alone) and with the serve
   prompts (drafts must be accepted on the loop), chunked prefill
   (``prefill_chunk=256``, a 900-token prompt added; at least four
   chunks) and the int8 KV pool (at most 0.52 of the bf16 pool's bytes),
   with the agreement of their tokens with the plain engine's (bf16 is
   not token-exact between GEMM shapes), decode tokens/s, the time per
   chunk and to first token, and one decode step's device time through
   each int8 path at two table capacities.
9. ``disagg``: the disaggregated hand-off on the same weights: a
   prefill engine (``prefill_chunk=64``) answers the five serve prompts
   prefill-only, each export ships over one device-tier edge
   (``KVBlockShipper`` -> ``KVLandingStrip``, the peer probed as another
   process, frames landing on the card through the page-locked segment)
   and a decode engine adopts it and decodes; then one request between
   two int8-pool engines (values and scales shipped).  The tier must be
   the device tier with no degraded frame, every landed tensor must equal
   its export bit for bit, nothing may re-prefill, every export must be
   adopted and both engines' block accounting must hold.  It reports
   per request the time to first token on the prefill side, export,
   ship, land and adopt times and bytes, the decode tokens/s (and the
   decode engine's rate with and without an idle landing thread
   polling, in turns) and the agreement with the ``serve`` phase's
   colocated tokens.
9b. ``llm_server``: the serving front on the same model, by name in a
   replica process on the card: ``serve.start`` (the HTTP proxy on a free
   loopback port) and ``serve.run(build_llm_deployment(...))``.  The five
   serve prompts one at a time over HTTP as SSE streams must each add up
   to, and equal, an in-process engine's answer on this process's
   same-seed weights; warm, a unary answer and its stream must be equal;
   then the five at once through the handle.  It prints the replica's
   start, each request's time to first token and end to end, the engine
   steps of the sequential and the concurrent five, the decode rate, and
   the K1-K4 launches counted in the replica process.
9c. ``llm_disagg``: a prefill and a decode replica behind the ingress
   (``build_disaggregated_llm_deployment``, a chunk budget of
   ``max_len``): the five prompts over HTTP and through
   ``disaggregated_handle().stream``, each answer equal to
   ``llm_server``'s; every request exported and adopted over the device
   tier, none re-prefilled.  It prints per hand-off the prefill, export,
   ship, land and adopt times (export and adopt in device time, from
   CUDA events), and the K1-K4 launches counted in both replicas.
9d. ``llm_batch``: ``build_llm_processor`` over twelve text prompts in
   batches of four, its engine built in the actor from this process's
   weights; the rows must equal an in-process engine's ``generate`` on
   the same batches.  The replicas are shut down before the training
   phases; ``python3 chip_smoke.py llm_server llm_disagg llm_batch`` runs
   the three alone.
10. ``train``: the 7B serving weights are freed, then ``make_llama_trainer``
   at Llama-2-7B width cut to 16 layers (fp32 params and AdamW state,
   bf16 activations, ``save_attn``) takes two warm-up and three timed
   steps on b=1, s=2048 random tokens; K1, K2 and K3 must each launch
   once per layer per step, and loss and grad norm must be finite.
10a. ``dag_pipeline``: the ``train`` phase's model (16 layers, fp32
   params, ``save_attn``) as two ``TrainStage`` processes of 8 layers
   under ``PipelineRunner(transport="channels")`` and the 1F1B schedule,
   four microbatches of one row.  One process first accumulates
   ``llama_loss``'s backward over the same microbatches from the same
   weights; after a warm-up run, every grad leaf of each stage must equal
   its slice bit for bit (else be reported and lie within ``BWD_TOL``),
   each stage must run its ops in ``build_1f1b_schedule(2, 4)`` order, K1,
   K2 and K3 must launch 32 times in each stage process and K4 never,
   and both edges must be on the device tier.  It prints the run's wall
   beside four chained ``train`` steps, the bubble beside the analytic
   one, each stage's busy and wait, and the memory of the reference and
   of each stage.
10b. ``mesh``: the ``train`` phase's step through the parallel layer: a
   world-1 NCCL process group, ``create_mesh(MESH_PRESETS["fsdp"])`` and
   ``make_llama_trainer(cfg, mesh)`` at the same width, depth, policy,
   seed and tokens, one warm-up and two timed steps.  The params must be
   DTensors, K1, K2 and K3 must each launch once per layer per step, and
   the first loss must be within rtol 1e-3 of ``train``'s (whether the
   two are bit-equal is printed); wall, busy ms, idle share and peak
   memory are printed beside ``train``'s.
10c. ``mesh4`` (only with four or more cards): four NCCL ranks, one per
   card, started and joined with a timeout: ``make_llama_trainer`` at
   Llama-2-7B's full 32 layers on ``fsdp=4`` (one row of s=2048 per
   rank) and on ``fsdp=2 x tp=2``, one warm-up and two timed steps each,
   K1/K2/K3 launching once per layer per step on every rank; then
   ``ring_attention`` over ``sp=4`` at s=8192 (bf16, 32 heads, d=128)
   against K1 on the whole sequence, to K1's bf16 forward tolerance.
10d. ``trainer``: the ``train`` phase's step through the multi-GPU
   trainer: ``TorchTrainer`` (``ray_tpu_torch.train``) starts one worker
   process bound to the card (this process holds under 1 GB then), whose
   loop (``trainer_loop``) runs two warm-up, three timed and one
   profiled step at the same width, depth, seed and tokens, each followed
   by an allreduce of its loss over the run's world-1 NCCL collective
   group, and reports every step.  K1, K2 and K3 must each launch once
   per layer per step in the worker, the first loss must equal
   ``train``'s within rtol 1e-5 (whether bit-equal is printed), and every
   allreduced loss must equal its loss bit for bit.  It prints the
   worker's start (``fit()`` to its CUDA context), ``fit()`` to the first
   report and the controller's overhead per step (the interval between
   two timed steps' reports less the step's wall).
10e. ``trainer_resume``: ``small_reference``'s small Llama trains four
   steps on the card through ``TorchTrainer``, reporting a
   ``Checkpoint.from_state_dict`` of its params and AdamW state after
   each; the first attempt raises at step 2 under ``FailureConfig(
   max_failures=1)`` and the restarted group resumes from the step-1
   checkpoint.  Its resumed steps' losses and last checkpoint must equal
   bit for bit those of the same steps run uninterrupted in this process
   on the same card.
10f. ``trainer4`` (only with four or more cards; else a line says so):
   ``TorchTrainer`` over four workers, one card each, on the ``fsdp``
   preset runs ``mesh4``'s ``fsdp4`` case through the session
   (``get_mesh``, ``shard_params``, ``shard_inputs``); its first loss
   must equal ``mesh4``'s within rtol 1e-5, K1/K2/K3 must launch once per
   layer per step on every rank; then the four-rank NCCL collective group
   runs allreduce, allgather, reducescatter and broadcast on 64 MiB of
   integer-valued fp32 per rank, each equal to the host's result bit for
   bit, with its ms per op.
10g. ``data_trainer``: the ``trainer`` phase's step fed by the data
   plane: ``TorchTrainer(..., datasets={"train": ds})`` on one worker
   with the card, ``ds`` ``from_numpy`` of 9 token rows [9, 2049] whose
   first is ``trainer``'s batch; the worker reads its
   ``streaming_split`` shard through ``iter_torch_batches(batch_size=1,
   prefetch_batches=2)`` (page-locked staging, a copy stream) for two
   warm-up, three timed and one profiled step, then the rest.  The
   first loss must be bit-equal to ``trainer``'s, K1, K2 and K3 must
   launch once per layer per timed step, every landed batch must have
   its host row's int64 sum and shape, and no segment of the split may
   outlive ``fit()``; it prints the H2D copy's device ms per batch (from
   the profiled step's trace), each step's wait for its batch, the step
   wall beside ``trainer``'s and the idle share.
11. ``train_save_attn_mlp`` and ``train_save_dots``: the same train step
   under the other two remat policies, from the same seed and tokens (one
   warm-up and two timed steps each): K1 launches once per layer per
   step under ``save_attn_mlp`` and twice under ``save_dots`` (which
   replays the flash forward), K2 and K3 once; the first step's loss
   must be bit-equal to ``save_attn``'s and its grad norm within rtol
   1e-3.
12. ``moe_forward``: ``moe_apply`` at Mixtral-8x7B width (GQA 32/8, 8
   experts, top-2) in bf16 weights cut to 24 of 32 layers (or the
   deepest that leaves 8 GB free, reckoned and printed before anything
   is allocated), b=1, s=2048: one warm-up and three timed forwards; K1
   launches once per layer; TFLOP/s by the dense dispatch's FLOPs and by
   the active top-2 FLOPs.
13. ``moe_train``: ``make_moe_trainer`` at Mixtral-8x7B width cut to 2
   layers (fp32 params and AdamW state, bf16 activations, each layer
   replayed whole as the reference's remat), b=1, s=2048, two warm-up
   and three timed steps; K1 must launch twice per layer per step, K2
   and K3 once.
14. ``vit_train``: ViT-B/16 at its published width, b=256, random
   images on the card; then ``data_vit``: the same step fed by
   ``iter_torch_batches(dtypes={"images": torch.float32},
   prefetch_batches=2)`` over eight batches of uint8 images [256, 224,
   224, 3] and int64 labels from seed 4 (38.5 MB per batch on the host,
   154 MB landed as fp32), two warm-up steps (the second profiled) and
   six chained steps.  Every
   landed batch must equal the host's cast on the card bit for bit and
   every loss be finite; it prints images/s and step ms beside
   ``vit_train``'s, each step's wait for its batch, the host cast and
   the H2D copies' device ms per batch (from the profiled step's
   trace), the page-locked bytes and peak memory.  Then
   ``health`` and, with four cards, ``health4``.
15. The RL stack (``ray_tpu_torch.rl``, no kernel of K1-K4 on its
   paths; ``python3 chip_smoke.py rl_ppo rl_runners rl_multi_agent
   rl_families`` runs them alone).  ``rl_ppo``: the vectorized mode of
   ``benchmarks/rl_ppo_bench.py``, PPO on CartPole-v1 as tensors on the
   card (1024 envs x 128 steps, hidden (64, 64), lr 3e-4, 2 epochs x 4
   minibatches, 20 iterations); it must learn as the reference's test
   holds it (late > 1.5 x early, late > 40), and one update and one GAE
   on the card must match the CPU's from the same inputs.  It prints env
   steps/s, ms per iteration, the rollout and the update apart, one
   profiled iteration's busy ms and idle share, and the reward curve.
   ``rl_runners``: the bench's distributed mode, 4 runner processes x 32
   envs x 128 steps on the host, the learner on the card (gymnasium's
   CartPole where gymnasium imports, else ``HostCartPole``, registered
   in the driver and carried to the runners); one runner's process is
   killed between iterations, and the next must finish with it
   respawned.  ``rl_multi_agent``: PursuitTag, 512 envs x 128 steps,
   independent learners that must start equal and diverge.
   ``rl_families``: DQN, SAC, IMPALA, APPO, CQL, BC, MARWIL and
   DreamerV3 at their reference defaults, two iterations each, losses
   finite, one update against the CPU (Dreamer: the world-model loss and
   update with the same latent noise).
16. The RLHF loop, weight sync and the tiered checkpoint plane
   (``python3 chip_smoke.py rlhf trainer_tiered`` runs them alone).
   ``rlhf``: ``RLHFLoop`` with the reference's end-to-end configuration
   (4 iterations, 2 rollout processes on the host, batch 32, every read
   verified against its digest, a rollout process killed at iteration 2,
   a publish fault at 2 and a reward fault at 3), the learner on the
   card in one worker; it must finish every iteration with every fault
   fired, a respawn, the killed batch dropped and none counted twice,
   consumed versions non-decreasing, version 5 at epoch 0 and a finite
   loss, and one learner update on the card must match the CPU's.  It
   prints each iteration's wall split into rollout, reward, update and
   publish, the publisher's and subscribers' stats, the worker's and
   rollout processes' start-up, and K1-K4 counted in the worker (0).
   ``weight_sync_7b``: a ``WeightPublisher`` on the card publishes five
   versions of a Llama-2-7B-width, 2-layer bf16 tree (1.33 GB) to a
   ``WeightSubscriber`` in a CPU process, the last two into
   reused payload slots; each version must be adopted with its digest
   matching and every leaf's sha256 equal to the card's.  ``trainer_tiered``: ``TorchTrainer`` with one worker on
   the card, ``CheckpointConfig(mode="tiered")`` and one restart
   allowed, the ``trainer`` phase's step at 1 layer (fp32 params, both
   AdamW moments: 5.6 GB per generation, after a host-memory reckoning);
   each of 7 steps saves through ``ctx.checkpointer()``, the first
   attempt raises at step 3 after its loss, and the restarted worker
   must restore from peer RAM with 0 disk reads, every leaf equal to the
   step-2 save's sha256, step 3's loss bit-equal, K1 = K2 = K3 = 1 per
   step, and its fourth save in the first's snapshot buffer.
17. ``dag4`` (only with four or more cards; else a line says so): four
   ``DPStage`` actors, one card each, take three data-parallel steps of a
   2-layer Llama-2-7B-width model as one compiled DAG: each a local
   gradient of its own batch, ``allreduce.bind(..., backend="nccl")``
   overlapped with independent compute, then SGD.  The replicas' params
   must be bit-identical after each step, and at step 0 the allreduced
   gradient must lie within the fp32 bound of the four local gradients
   summed in one process.

Then the ``kernels`` line (every ported kernel with its launches on its
main path: K1, K2 and K3 in ``train``, K4 in ``ring``; the launches of
every path that runs it, the DAG paths' counted in their stage
processes, the trainer paths' counted in their workers,
0 on the serving and the RL paths (the RL paths' by the profiler),
K1-K3 1 per step on ``trainer_tiered`` and 0 on ``rlhf`` (in its
worker) and ``weight_sync_7b``, and K1-K3 at
Mixtral's attention shape), the
``nvidia-smi`` line and, last, the result line
``{"ok": true, "device": {...}}``.  Every process a phase starts forks
from the worker zygote: each phase line that started any carries
``starts`` (the children the zygote forked for this process since the
previous phase line, and any cold start, fallback or zygote restart),
and a fallback or a restart anywhere, or a cold start outside
``startup``, fails the run.  Any failure raises: the traceback is
printed, the exit code is non-zero and no result line is printed.  Without
CUDA, or without the package beside it, the script exits non-zero at once.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

# when this module began, and when it had imported torch and the port: a
# child re-imports its starter's main module before its target runs, and
# the startup phase splits a child's start-up at these stamps
_T_MAIN = time.time()
import torch  # noqa: E402,F401
_T_TORCH = time.time()
try:  # the runner path's host env derives from the port's gym adapter
    from ray_tpu_torch.rl.env import EnvSpec as _EnvSpec
    from ray_tpu_torch.rl.env import GymVectorEnv as _GymVectorEnv
except ImportError:  # chip_smoke.py without the package: main() refuses
    _EnvSpec, _GymVectorEnv = None, object
_T_PORT = time.time()

SEQ = 2048          # forward phase sequence length (b = 1)
SERVE_SLOTS = 4
SERVE_MAX_LEN = 1024
SERVE_BLOCK = 16
SERVE_NEW_TOKENS = 32
# serve_options: the drafter's tokens per verify, the plain tokens of
# the warm run (from a serve prompt, and the loop prompt), the new tokens
# of a request served alone on the loop prompt, the chunk budget and the
# long prompt, and the table capacities of the int8 decode-step timing
SPEC_TOKENS = 4
LOOP_WARM_TOKENS = 96
LOOP_NEW_TOKENS = 64
PREFILL_CHUNK = 256
LONG_PROMPT = 900
CROSSOVER_LENS = (176, 512)
# disagg: the prefill engine's chunk budget (a long prompt no longer
# stalls the other admissions; the reference's prefill pool defaults to
# 4 blocks, 64 tokens at block 16)
DISAGG_CHUNK = 64
# the decode-rate A/B with an idle landing strip: new tokens per run
POLL_TOKENS = 16
TRAIN_LAYERS = 16
TRAIN_STEPS = 3
DEPTH_CUT = ("32 → 16 layers: fp32 params + AdamW state of the full depth "
             "is ~108 GB")
# the Llama train step under the other remat policies (same width, depth,
# batch, seed and tokens as train): warm-up and timed steps
POLICY_WARMUP, POLICY_STEPS = 1, 2
# the mesh phase (the train step through a world-1 mesh): warm-up and
# timed steps; mesh4: ranks, the ring's sequence, and the seconds the
# ranks get before they are killed
MESH_WARMUP, MESH_STEPS = 1, 2
MESH4_RANKS = 4
MESH4_MESHES = {"fsdp4": {"dp": 1, "fsdp": 4},
                "fsdp2_tp2": {"dp": 1, "fsdp": 2, "tp": 2}}
MESH4_RING_SEQ = 8192
MESH4_TIMEOUT_S = 600
# the trainer phases (TorchTrainer over worker processes): the
# small resumed run's steps and the step its first attempt fails at, and
# trainer4's collectives (bytes of integer-valued fp32 per rank, timed
# calls per op)
RESUME_STEPS = 4
RESUME_FAIL_AT = 2
TRAINER4_COLLECTIVE_BYTES = 64 << 20
TRAINER4_COLLECTIVE_ITERS = 5
# the serving meshes of ``serve_mesh4`` (four cards, full depth); at
# ``dp=2 x pp=2`` (tp=1) each stage runs one card's ops on its layers, so
# its logits differ from one card's only by what the pp hand-off and the
# logits' broadcast change
SERVE_MESH4_MESHES = {"tp4": {"dp": 1, "tp": 4},
                      "pp2_tp2": {"dp": 1, "pp": 2, "tp": 2},
                      "dp2_pp2": {"dp": 2, "pp": 2}}
SERVE_MESH4_TIMEOUT_S = 600
# the four-card phases a run may name alone (``python3 chip_smoke.py
# serve_mesh4 mesh4 trainer4 health4``); trainer4 runs mesh4 first, whose
# first loss it is held to
FOUR_CARD_PHASES = {"serve_mesh4", "mesh4", "trainer4", "health4", "dag4",
                    "mesh_group4"}
# the compiled-graph DAG's phases: two stage processes on one card
# (dag_forward: 16 + 16 layers of Llama-2-7B in bf16; dag_pipeline: the
# train phase's 16 layers as 8 + 8 under 1F1B), frames of one 16 MiB
# activation and its tokens, executions and microbatches; dag4's data-
# parallel model (2 layers) and steps
DAG_PHASES = {"dag_forward", "dag_pipeline"}
DAG_BUFFER_BYTES = 32 << 20
DAG_FORWARD_EXECS = 8
DAG_INFLIGHT = 2
DAG_MICROBATCHES = 4
DAG4_LAYERS = 2
DAG4_STEPS = 3
DIGEST_CHUNK = 1 << 26
# the data-plane phases a run may name alone too (``python3 chip_smoke.py
# data_trainer data_vit``): data_trainer runs train and trainer first,
# data_vit runs vit_train first, the phases each is held to
DATA_PHASES = {"data_trainer", "data_vit"}
# the serving front's phases a run may name alone too (``python3
# chip_smoke.py llm_server llm_disagg llm_batch``; llm_disagg runs
# llm_server first, whose answers it is held to); the serve phase's
# engine by name (Llama-2-7B, bf16 weights from seed 0), and the batch
# phase's rows and batch
SERVING_PHASES = {"llm_server", "llm_disagg", "llm_batch"}
LLM_ENGINE_KW = {"model": "llama2_7b", "batch_slots": SERVE_SLOTS,
                 "max_len": SERVE_MAX_LEN, "block_size": SERVE_BLOCK}
LLM_BATCH_ROWS, LLM_BATCH_SIZE = 12, 4
# the RL phases a run may name alone too (``python3 chip_smoke.py rl_ppo
# rl_runners rl_multi_agent rl_families``): rl_ppo is the vectorized mode
# of benchmarks/rl_ppo_bench.py (CartPole-v1 envs x fragment, iterations),
# rl_runners its distributed mode (runner processes x envs each,
# iterations), rl_multi_agent its run_multi_agent (envs, iterations), and
# rl_families each other family at its reference defaults for a few
# iterations.  Tolerances of the CPU-against-card checks, stated before
# the first reading: the parameters after an update (PPO's eight
# minibatch steps, one step elsewhere) within 1e-4 (a tenth of one Adam
# step at lr 1e-3; fp32 products on the card, not TF32, sum in another
# order), GAE within 1e-5 (a fp32 reverse sum over 128 steps), Dreamer's
# world-model loss within rtol 1e-5
RL_PHASES = {"rl_ppo", "rl_runners", "rl_multi_agent", "rl_families"}
RL_PPO_ENVS, RL_FRAGMENT, RL_PPO_ITERS = 1024, 128, 20
RL_RUNNERS, RL_RUNNER_ENVS, RL_RUNNER_ITERS = 4, 32, 5
RL_MA_ENVS, RL_MA_ITERS = 512, 20
RL_FAMILY_ITERS = 2
RL_PARAMS_ATOL, RL_GAE_ATOL, RL_DREAMER_LOSS_RTOL = 1e-4, 1e-5, 1e-5
# the RLHF loop, weight sync and the tiered checkpoint plane
TIERED_PHASES = {"rlhf", "trainer_tiered"}
# the CPU tests' tolerances for the RLHF learner: a loss from the same
# params and batch, params after Adam steps
RLHF_LOSS_ATOL, RLHF_PARAMS_ATOL = 1e-6, 1e-4
# five versions: the fourth and fifth reuse the first two's payload slots
WS7B_LAYERS, WS7B_VERSIONS = 2, 5
# seven steps: the restarted worker saves four times, the fourth into the
# first's snapshot buffer
TIERED_LAYERS, TIERED_STEPS, TIERED_FAIL_AT = 1, 7, 3
# the data_vit phase's page-locked H2D copy on the H100 80GB HBM3 at
# 700 W: 154 MB in 2.929 ms
PINNED_COPY_GBPS = 154.14e6 / 2.929e-3 / 1e9
# the profiler's kernel names of K1-K4 (by fragment)
RL_PROFILER_NAMES = {"K1": "flash_fwd", "K2": "flash_bwd_dq",
                     "K3": "flash_bwd_dkv", "K4": "remote_"}
# vit_train: ViT-B/16 at its published width, images per step and timed
# steps
VIT_BATCH = 256
VIT_STEPS = 3
# data_trainer: token rows of its dataset (the loop's six steps take one
# each; the rest land after them); data_vit: batches of its dataset, of
# them warm-up steps
DATA_TRAINER_ROWS = 9
DATA_VIT_BATCHES = 8
DATA_VIT_WARMUP = 2
# the health plane end to end: steps and step seconds of the reference's
# loop on three host slots; on four cards steps and each step's bf16
# matmuls of HEALTH4_N square (~70 ms).  The degraded steps must outlast
# the detection: each probe is a new process (~10 s on the card
# machine's host), two per confirmation
HEALTH_STEPS, HEALTH_STEP_S = 100, 0.2
HEALTH4_STEPS, HEALTH4_MATMULS, HEALTH4_N = 400, 40, 8192
# Mixtral-8x7B: the forward in bf16 weights, and the train step in fp32
# params + AdamW; the forward keeps MOE_RESERVE bytes of the card free
MOE_FORWARD_LAYERS = 24
MOE_FORWARD_STEPS = 3
MOE_RESERVE = 8e9
MOE_FORWARD_CUT = ("32 → 24 layers: bf16 weights of the full depth are "
                   "93.4 GB, of 24 layers 70.2 GB")
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_CUT = ("32 → 2 layers: fp32 params + grads + AdamW moments are "
                 "16 B per param, 50.6 GB at 2 layers and 73.9 GB at 3, "
                 "where a 3.76 GB expert leaf's AdamW temporaries would not "
                 "fit")
# published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# fp32 on the CUDA cores, HBM3 bandwidth, NVLink each way
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
PEAK_NVLINK_BYTES = 450e9
# host seconds that a profiler window stays open before the first call and
# after the card finishes (``device_events``)
PROFILE_PAD_S = 0.05
# windows per pad (PROFILE_PAD_S and none) that the env phase counts
# kernels lost in (``profiler_window_losses``)
PROFILER_WINDOWS = 40
# the channel plane's payload: one Llama-2-7B pipeline-stage activation
# [b=1, s=SEQ, hidden 4096] in bf16, 16 MiB
ACTIVATION = (1, SEQ, 4096)
RING_RANKS = 4
RING_SHIFTS = (1, 3)
RING_SPLIT_WARMUP, RING_SPLIT_RINGS = 2, 8
CHANNEL_FRAMES = 10
# the single-process multi-card group (mesh_group on cuda:0, mesh_group4
# on four cards): integer-valued fp32 elements per rank of the
# reductions (64 MiB), timed calls per op, the DAG mesh owner's fp32
# elements per card (16 MiB) and its executions; a partial permutation
# of four ranks (ranks 1 and 2 receive nothing and must read zeros)
MESH_GROUP_INT_NUMEL = 1 << 24
MESH_GROUP_ITERS = 10
MESH_GROUP_DAG_NUMEL = 1 << 22
MESH_GROUP_DAG_EXECS = 3
MESH_GROUP_PARTIAL = ((0, 3), (3, 0))
MESH_GROUP_REDUCE_OPS = ("sum", "max", "min", "product")
# the startup phase: children per start method, and each child's first K1
# (b, s, h, d; bf16, causal, K1_CASES's bf16 tolerances)
STARTUP_CHILDREN = 4
STARTUP_K1 = (1, 256, 8, 128)
STARTUP_STAGES = ("process", "interpreter", "torch", "port", "entry",
                  "context", "kernel_lib", "k1", "reply")
# K4: its copy kernel's name; the hops of the cross-stream completion;
# the sleep that lets the host queue a whole hop before the card reaches
# it (~0.1 ms)
K4_KERNEL = "remote_copy_bulk_kernel"
K4_CROSS_HOPS = 64
K4_SLEEP_CYCLES = 200_000

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
    # Mixtral-8x7B's attention (GQA 32/8), the shape of moe_forward and
    # moe_train
    ("mixtral_gqa", 1, SEQ, 32, 8, 128, "bfloat16", True, 2e-2, 1e-3),
]

# K2/K3 against their plain version, per output (dq, dk, dv): elementwise
# |kernel - plain| <= atol + rtol |plain|, and over the whole output
# ||kernel - plain|| <= rel_l2 ||plain||.  bf16: both sides round P, dS and
# the outputs to bf16 from fp32 sums taken in another order, so an element
# that differs is off by about one bf16 ulp (rtol 2^-7); atol is twice the
# largest reading of the bf16 cases on the H100 (dq 9.8e-4, dk 3.9e-3,
# dv 7.8e-3).  Such scattered ulps keep the relative L2 error far below
# 1e-3, while a systematic error does not: a scale off by 1% reads 1e-2.
# fp32: atol about 4x the readings (dq 3.6e-7, dk 5.7e-6, dv 1.1e-5).
BWD_TOL = {
    "bfloat16": {"atol": (2e-3, 8e-3, 1.6e-2), "rtol": 2 ** -7,
                 "rel_l2": 1e-3},
    "float32": {"atol": (2e-6, 2.5e-5, 5e-5), "rtol": 1e-5,
                "rel_l2": 1e-5},
}


_STARTS_SEEN = {}  # the worker zygote's counts at the last phase line


def emit(obj) -> None:
    """Print ``obj`` as one JSON line.  A phase line gains ``starts``, the
    processes this process started since the previous phase line, when
    it started any; it fails the run, once printed, on a start that fell
    back to ``spawn`` or found the zygote dead, and on a cold start
    outside the ``startup`` phase."""
    if isinstance(obj, dict) and "phase" in obj:
        from ray_tpu_torch._private import worker_zygote

        now = worker_zygote.stats()
        delta = {k: now[k] - _STARTS_SEEN.get(k, 0) for k in (
            "children", "cold", "fallbacks", "restarts", "zygote_starts")}
        _STARTS_SEEN.update(now)
        if any(delta.values()):
            obj = {**obj, "starts": {**delta,
                                     "zygote_pid": now["zygote_pid"]}}
            print(json.dumps(obj), flush=True)
            if delta["fallbacks"] or delta["restarts"] or (
                    delta["cold"] and obj["phase"] != "startup"):
                raise AssertionError(f"{obj['phase']}: a process did not "
                                     f"start through the worker zygote: "
                                     f"{obj['starts']}")
            return
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


def attention_flops(b, sq, sk, h, d, causal, flops_per_d=4) -> float:
    """``flops_per_d * d`` FLOPs per visible (q, k) pair: 4 for K1 (QK^T
    and PV), 6 for K2, 8 for K3."""
    if causal:
        pairs = sum(min(i + 1, sk) for i in range(sq))
    else:
        pairs = sq * sk
    return float(flops_per_d) * d * pairs * b * h


def attention_bound(b, sq, sk, h, kv_h, d, dtype, causal, flops_per_d=4,
                    q_sized=2, kv_sized=2, fp32_rows=1):
    """Least time for an attention kernel: each input read once, each
    output written once, against ``flops_per_d * d`` FLOPs per visible
    (q, k) pair.  ``q_sized`` / ``kv_sized`` count the [b, s, h, d] /
    [b, s, kv_h, d] tensors it reads or writes, ``fp32_rows`` the fp32
    [b, h, s] ones (lse, D).  K1: 4, 2 (q, O), 2 (k, v), 1 (lse); K2: 6, 3
    (q, dO, dQ), 2, 2 (lse, D); K3: 8, 2 (q, dO), 4 (k, v, dK, dV), 2."""
    esize = 2 if dtype == "bfloat16" else 4
    flops = attention_flops(b, sq, sk, h, d, causal, flops_per_d)
    nbytes = esize * (q_sized * b * sq * h * d + kv_sized * b * sk * kv_h * d) \
        + 4 * fp32_rows * b * h * sq
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


def rates(flops, ms, bound_ms) -> dict:
    """What a kernel is judged by beside its time: TFLOP/s achieved and
    the share of its bound (bound_ms / ms)."""
    return {"tflops": flops / ms / 1e9, "bound_share": bound_ms / ms}


def train_flops_per_step(cfg, batch, seq) -> float:
    """The FLOPs the JAX bench counts per train step (``bench.py``,
    ``train_flops_per_step``): 6*N per token for the dense matmuls (fwd 2N
    + bwd 4N) plus causal attention, 12*b*s^2*h*hd per layer * 0.5."""
    n_matmul = cfg.num_params() - cfg.vocab_size * cfg.hidden_size
    dense = 6 * n_matmul * batch * seq
    hd = cfg.resolved_head_dim
    attn = 12 * cfg.num_layers * batch * seq * seq * cfg.num_heads * hd * 0.5
    return dense + attn


def moe_forward_flops(cfg, batch, seq, experts) -> float:
    """FLOPs of one MoE forward with ``experts`` experts computing each
    token: 2 per multiply-add of every product (q, k, v, o, the router,
    each expert's gate, up and down, the head) plus causal attention
    (``attention_flops``).  ``experts = cfg.num_experts`` counts what the
    dense dispatch computes, ``cfg.experts_per_token`` the active
    (top-k) FLOPs that a sparse dispatch would."""
    h, hd = cfg.hidden_size, cfg.resolved_head_dim
    per_token_layer = 2 * h * (2 * cfg.num_heads * hd
                               + 2 * cfg.num_kv_heads * hd
                               + cfg.num_experts
                               + experts * 3 * cfg.mlp_dim)
    dense = batch * seq * (cfg.num_layers * per_token_layer
                           + 2 * h * cfg.vocab_size)
    return dense + cfg.num_layers * attention_flops(
        batch, seq, seq, cfg.num_heads, hd, True)


def moe_forward_bytes(cfg, layers, seq) -> dict:
    """What ``moe_forward`` reckons before it allocates, in bytes: the bf16
    weights at ``layers`` deep, and the largest transients of a forward of
    b=1 (the two folded [h, E*m] weights, gate, up and the swiglu output
    [s, E*m], the E experts' outputs, the logits and the fp32 head)."""
    per_layer = (cfg.num_params() - 2 * cfg.vocab_size * cfg.hidden_size
                 - cfg.hidden_size) // cfg.num_layers
    weights = 2 * (2 * cfg.vocab_size * cfg.hidden_size + cfg.hidden_size
                   + layers * per_layer)
    em, h = cfg.num_experts * cfg.mlp_dim, cfg.hidden_size
    transients = (2 * (2 * h * em + 3 * seq * em
                       + cfg.num_experts * seq * h)
                  + 4 * (seq * cfg.vocab_size + h * cfg.vocab_size))
    return {"weights": weights, "transients": transients}


def ptxas_report(text):
    """``nvcc -Xptxas -v`` output as ``{"kernels": {name<args>: {registers,
    spill_stores, spill_loads}}, "warnings": [...]}``."""
    kernels, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"((?:flash|remote)_[a-z_]+?_kernel)(?:I(\w*?)E)?E",
                          m.group(1))
            args = (k.group(2) or "").replace("13__nv_bfloat16", "bf16,") \
                .replace("Li", "") if k else ""
            if args.startswith("f"):
                args = "f32," + args[1:]
            name = (f"{k.group(1)}<{args}>" if args else k.group(1)) if k \
                else m.group(1)
            kernels[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name:
            kernels[name].update(spill_stores=int(m.group(1)),
                                 spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            kernels[name]["registers"] = int(m.group(1))
    return {"kernels": kernels,
            "warnings": [ln.strip() for ln in text.splitlines()
                         if "warning" in ln.lower()]}


def phase_env():
    import torch

    from ray_tpu_torch._private import accelerators
    from ray_tpu_torch.ops.cuda import _build

    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    nvcc = run([_build.nvcc_path(), "--version"]).splitlines()[-1]
    t0 = time.perf_counter()
    log = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: ptxas_report(entry["ptxas"])
             for name, entry in log.items()}
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "accelerators": {
              "resources": accelerators.detect_resources(),
              "labels": accelerators.detect_labels(),
              accelerators.ENV_VISIBLE: os.environ.get(
                  accelerators.ENV_VISIBLE)},
          "build_s": build_s, "ptxas": ptxas,
          "profiler_windows": {
              "windows": PROFILER_WINDOWS, "pad_s": PROFILE_PAD_S,
              "losing_kernels": profiler_window_losses(PROFILER_WINDOWS,
                                                       PROFILE_PAD_S),
              "losing_kernels_unpadded": profiler_window_losses(
                  PROFILER_WINDOWS, 0.0)}})
    spills = {k: r for lib in ptxas.values()
              for k, r in lib["kernels"].items()
              if "wgmma" in k and (r.get("spill_stores")
                                   or r.get("spill_loads"))}
    if spills:
        raise AssertionError(f"the tensor-core kernels spill: {spills}")
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
        kernel_ms = [t for n, t in device_times(lambda: flash_attention_fwd(
            q, k, v, causal=causal), 5).items() if "flash_fwd" in n]
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
               "atol_rtol": tol_o, "ms": ms,
               "kernel_ms": kernel_ms[0] if len(kernel_ms) == 1
               else "not measured", "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by,
               **rates(attention_flops(b, s, s, h, d, causal), ms, bound_ms)}
        emit(row)
        do = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dt)
        bwd = phase_kernels_bwd(q, k, v, out, lse, do, causal,
                                BWD_TOL[dtype])
        bwd.update({"phase": "kernel", "kernel": "K2 flash_bwd_dq + "
                    "K3 flash_bwd_dkv", "case": name})
        for kname, flops_per_d, q_sized, kv_sized in (("k2", 6, 3, 2),
                                                      ("k3", 8, 2, 4)):
            bwd[f"{kname}_bound_ms"], bwd[f"{kname}_bound_by"] = \
                attention_bound(b, s, s, h, kv_h, d, dtype, causal,
                                flops_per_d, q_sized, kv_sized, 2)
            for key, val in rates(
                    attention_flops(b, s, s, h, d, causal, flops_per_d),
                    bwd[f"{kname}_ms"], bwd[f"{kname}_bound_ms"]).items():
                bwd[f"{kname}_{key}"] = val
        emit(bwd)
        results[name] = {"k1": row, "bwd": bwd}
        del q, k, v, qt, kt, vt, out, lse, pout, plse, err_o, do
        torch.cuda.empty_cache()
    return results


def phase_kernels_bwd(q, k, v, out, lse, do, causal, tol):
    """K2 and K3 (through ``flash_attention_bwd``) against
    ``flash_attention_bwd_plain`` on the same residuals, within ``tol``
    (an entry of ``BWD_TOL``) on dq, dk and dv; each kernel's device time
    by name (torch.profiler; each must be the design its dtype takes),
    the wrapper's (D = rowsum(dO * O) and both launches), the plain
    version's, and SDPA's backward (forward+backward minus forward, flash
    backend where it takes the inputs) as the library yardstick."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from ray_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain)

    def kernels():
        return flash_attention_bwd(q, k, v, out, lse, do, causal=causal)

    got = kernels()
    torch.cuda.synchronize()
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal)
    row, faults = {"tolerance": tol}, []
    for name, atol, a, w in zip(("dq", "dk", "dv"), tol["atol"], got,
                                want):
        a, w = a.float(), w.float()
        err = (a - w).abs()
        rel_l2 = float(torch.linalg.vector_norm(a - w)
                       / torch.linalg.vector_norm(w))
        n_bad = int((err > atol + tol["rtol"] * w.abs()).sum())
        row.update({f"{name}_max_abs_err": float(err.max()),
                    f"{name}_elements_over": n_bad,
                    f"{name}_rel_l2_err": rel_l2,
                    f"{name}_mean_abs": float(w.abs().mean()),
                    f"{name}_max_abs": float(w.abs().max())})
        if n_bad or not rel_l2 <= tol["rel_l2"] \
                or not bool(torch.isfinite(a).all()):
            faults.append(name)
    if faults:
        raise AssertionError(f"K2/K3: {', '.join(faults)} disagree with the "
                             f"plain version: {json.dumps(row)}")
    if q.dtype == torch.bfloat16:
        row["dq_flipped_vs_exact"] = dq_flipped_vs_exact(
            q, k, v, out, lse, do, causal,
            {"kernel": got[0], "plain": want[0]})
    times = device_times(kernels, iters=5)
    # each kernel by either name: the tensor-core kernel, which bf16 must
    # launch, or the FMA kernel, which fp32 must launch
    want_design = "wgmma" if q.dtype == torch.bfloat16 else "fma"
    for kname, names in (("k2", ("flash_bwd_dq_wgmma_kernel",
                                 "flash_bwd_dq_kernel")),
                         ("k3", ("flash_bwd_dkv_wgmma_kernel",
                                 "flash_bwd_dkv_kernel"))):
        found = [(n, ms) for n, ms in times.items()
                 if any(x in n for x in names)]
        if len(found) != 1:
            raise AssertionError(f"no single device time for {names} in "
                                 f"the profile: {sorted(times)}")
        design = "wgmma" if "wgmma" in found[0][0] else "fma"
        if design != want_design:
            raise AssertionError(f"{q.dtype} launched {found[0][0]}, not "
                                 f"the {want_design} kernel")
        row[f"{kname}_kernel"], row[f"{kname}_ms"] = found[0][0][:80], \
            found[0][1]
        row[f"{kname}_design"] = design
    row["bwd_ms"] = cuda_ms(kernels)
    row["plain_ms"] = cuda_ms(lambda: flash_attention_bwd_plain(
        q, k, v, out, lse, do, causal=causal), 5)
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    gqa = {"enable_gqa": True} if q.shape[2] != k.shape[2] else {}

    def library_fwd():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]):
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal, **gqa)

    row["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
        library_fwd(), (qt, kt, vt), dot)) - cuda_ms(library_fwd)
    return row


def dq_flipped_vs_exact(q, k, v, out, lse, do, causal, dqs):
    """How many elements of each bf16 dq in ``dqs`` stand further from dq
    built on exact dS than the output's own rounding allows (2^-8 |w| +
    5e-4).  Exact: S, dP and dS in fp64 from the same bf16 inputs, lse and
    D, dS rounded once to bf16, then dS K in fp64.  dS is rounded to bf16
    before dS K, so a large dS whose fp32 value lands on the other side of
    a rounding midpoint moves its whole row of dq: this counts the rows'
    elements so moved, for the kernel beside the plain version."""
    import torch

    b, s, h, d = q.shape
    n_rep = h // k.shape[2]
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    visible = torch.ones(s, s, dtype=torch.bool, device=q.device)
    if causal:
        visible = visible.tril()
    counts = dict.fromkeys(dqs, 0)
    for bi in range(b):
        for hi in range(h):
            qh, doh = q[bi, :, hi].double(), do[bi, :, hi].double()
            kh = k[bi, :, hi // n_rep].double()
            vh = v[bi, :, hi // n_rep].double()
            p = torch.exp((qh @ kh.T) * d ** -0.5
                          - lse[bi, hi].double()[:, None])
            ds = torch.where(visible, p, 0.0) * (
                doh @ vh.T - delta[bi, hi].double()[:, None])
            w = (ds.to(q.dtype).double() @ kh) * d ** -0.5
            for name, dq in dqs.items():
                err = (dq[bi, :, hi].double() - w).abs()
                counts[name] += int((err > 2 ** -8 * w.abs() + 5e-4).sum())
    return counts


def activation_shards(device="cuda", n=RING_RANKS, shape=ACTIVATION,
                      dtype="bfloat16", seed=11):
    """``n`` ranks' tensors of ``shape`` (random, from ``seed``)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)
    out = [torch.randn(shape, generator=gen, device=device)
           for _ in range(n)]
    if not dt.is_floating_point:
        out = [x.mul_(40).round_() for x in out]
    return [x.to(dt) for x in out]


def _same_bits(a, b) -> bool:
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def k4_ring_case(shards, shift):
    """One ring through K4 (``device_ring_copy``) against the same ring
    through its plain version (``copy_``): bit-exact, one launch per hop.
    Returns the launches and the largest |difference|."""
    from ray_tpu_torch.experimental.channel.transport import device_ring_copy
    from ray_tpu_torch.ops.cuda.remote_copy import (remote_copy,
                                                    remote_copy_plain)

    n = len(shards)
    before = remote_copy.launches
    got = device_ring_copy(shards, shift=shift)
    launches = remote_copy.launches - before
    want = [None] * n
    for i, x in enumerate(shards):
        j = (i + shift) % n
        want[j] = x.new_empty(x.shape, device=shards[j].device)
        remote_copy_plain(x, want[j])
    err = max(float((g.float() - w.float()).abs().max()) if g.numel()
              else 0.0 for g, w in zip(got, want))
    if launches != n or not all(_same_bits(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"K4 ring of {n} ({tuple(shards[0].shape)} "
                             f"{shards[0].dtype}, shift {shift}): {launches} "
                             f"launches, max |d| {err} against copy_")
    return launches, err


def device_ms(fn, iters):
    """Device time per call of ``fn``, all its kernels summed
    (``device_times``), or "not measured"."""
    return sum(device_times(fn, iters).values()) or "not measured"


def rotate(fn, srcs, dsts):
    """A call that runs ``fn`` on the next (src, dst) pair each time, so
    each finds its bytes cold in L2."""
    state = {"k": 0}

    def hop():
        k = state["k"] = (state["k"] + 1) % len(srcs)
        fn(srcs[k], dsts[k])
    return hop


def k4_copy_ms(times):
    """The copy kernel's device time among ``device_times``' kernels."""
    ms = [t for name, t in times.items() if K4_KERNEL in name]
    return ms[0] if ms else "not measured"


def k4_hop_ms(srcs, dsts, iters=20):
    """Per hop that rotates through the (src, dst) pairs: the device time
    of K4 (its copy, and on a peer its wait kernel) and of ``copy_`` in
    turns (plain, K4, K4, library), by the profiler; the copy kernel
    alone, and the names of the kernels a hop launched; and the wall time
    of back-to-back hops by CUDA events, which includes the host's launch
    gaps.  Across two cards the sum counts the wait kernel, which spins
    on the destination while the copy runs on the source: there the copy
    kernel alone is the hop."""
    from ray_tpu_torch.ops.cuda.remote_copy import (check_remote_copies,
                                                    remote_copy,
                                                    remote_copy_plain)

    plain_ms = device_ms(rotate(remote_copy_plain, srcs, dsts), iters)
    ms = device_ms(rotate(remote_copy, srcs, dsts), iters)
    ms_again = device_ms(rotate(remote_copy, srcs, dsts), iters)
    library_ms = device_ms(rotate(remote_copy_plain, srcs, dsts), iters)
    times = device_times(rotate(remote_copy, srcs, dsts), iters)
    hop_wall_ms = cuda_ms(rotate(remote_copy, srcs, dsts), iters)
    check_remote_copies()
    wait_ms = [t for name, t in times.items() if "remote_wait_kernel" in name]
    return {"ms": ms, "ms_again": ms_again, "plain_ms": plain_ms,
            "library_ms": library_ms, "design": sorted(times),
            "copy_kernel_ms": k4_copy_ms(times),
            "wait_kernel_ms": wait_ms[0] if wait_ms else "none launched",
            "hop_wall_ms": hop_wall_ms}


def k4_edge_counts(stage, sms):
    """Byte counts around every edge of K4's design: no whole vector, one
    vector and a byte, one stage (one chunk; past it the grid splits),
    two stages, the grid filling every SM, and the main path with a tail
    (its chunks not a multiple of the grid)."""
    return {"0": 0, "1": 1, "15": 15, "16": 16, "17": 17,
            "stage-16": stage - 16, "stage": stage, "stage+16": stage + 16,
            "2stage-16": 2 * stage - 16, "2stage": 2 * stage,
            "2stage+16": 2 * stage + 16,
            "sms*stage-16": sms * stage - 16,
            "sms*stage+16": sms * stage + 16,
            "16MiB+3": math.prod(ACTIVATION) * 2 + 3}


def k4_edge_cases():
    """One K4 hop on cuda:0 at each of ``k4_edge_counts``, bit-exact
    against its source with the 64 bytes either side of ``dst``
    untouched, one launch each, and the profiler naming the copy kernel
    (and no wait kernel)."""
    import torch

    from ray_tpu_torch.ops.cuda import remote_copy as rc

    gen = torch.Generator(device="cuda").manual_seed(17)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for name, nbytes in k4_edge_counts(rc.STAGE_BYTES, sms).items():
        src = torch.randint(0, 256, (nbytes,), generator=gen, device="cuda",
                            dtype=torch.uint8)
        buf = torch.full((nbytes + 128,), 0xA5, dtype=torch.uint8,
                         device="cuda")
        dst = buf[64:64 + nbytes]
        before = rc.remote_copy.launches
        names = sorted(device_times(lambda: rc.remote_copy(src, dst)))
        launches = rc.remote_copy.launches - before
        exact = (_same_bits(dst, src) and bool((buf[:64] == 0xA5).all())
                 and bool((buf[64 + nbytes:] == 0xA5).all()))
        if (not exact or launches != 1 or len(names) != 1
                or K4_KERNEL not in names[0]):
            raise AssertionError(f"K4 at {nbytes} bytes ({name}): bit-exact "
                                 f"{exact}, {launches} launches, kernels "
                                 f"{names}")
        rows.append({"case": name, "nbytes": nbytes,
                     "blocks": rc.grid_blocks(nbytes, sms)})
    return rows


def k4_cross_stream(hops=K4_CROSS_HOPS, iters=20):
    """The peer completion forced on one card, through the private
    launcher: each 16 MiB hop's copy, with its flag, on stream A, and its
    wait and a consumer that clones ``dst`` on stream B, over rotating
    buffers; every clone must equal its source bit for bit (a flag seen
    before the bytes would show here).  Then the time from a hop's start
    on A to its end on B (after the wait) against a bare copy's, both by
    CUDA events behind a sleep kernel, so the host has queued the whole
    hop before the card reaches it; and the kernels' device times."""
    import torch

    from ray_tpu_torch.ops.cuda import remote_copy as rc

    lib = rc._lib()
    dev = torch.device("cuda", torch.cuda.current_device())
    srcs = activation_shards(n=5, seed=16)
    dsts = [torch.zeros_like(x) for x in srcs[:4]]
    a, b = torch.cuda.Stream(), torch.cuda.Stream()
    comp = rc._Completion(dev, dev, a.cuda_stream)  # not registered
    freed, seen = [None] * len(dsts), []
    torch.cuda.synchronize()
    for h in range(hops):
        k = h % len(dsts)
        with torch.cuda.stream(a):
            if freed[k] is not None:
                a.wait_event(freed[k])
            rc._flagged_hop(lib, srcs[h % 5], dsts[k], comp, b)
        with torch.cuda.stream(b):
            seen.append(dsts[k].clone())
            freed[k] = b.record_event()
    torch.cuda.synchronize()
    wrong = [h for h, got in enumerate(seen)
             if not _same_bits(got, srcs[h % 5])]
    if wrong or int(comp.words[2]):
        raise AssertionError(f"K4 cross-stream completion: hops {wrong} "
                             f"differ from their source, status "
                             f"{int(comp.words[2])}")
    del seen

    def latency_ms(flagged):
        pairs = []
        for h in range(iters):
            k = h % len(dsts)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(a):
                a.wait_stream(b)
                torch.cuda._sleep(K4_SLEEP_CYCLES)
                start.record(a)
                if flagged:
                    rc._flagged_hop(lib, srcs[k], dsts[k], comp, b)
                else:
                    rc._launch_copy(lib, srcs[k], dsts[k])
            end.record(b if flagged else a)
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters

    bare_ms = latency_ms(False)
    hop_ms = latency_ms(True)
    hop_again_ms = latency_ms(True)
    bare_again_ms = latency_ms(False)

    def flagged(src, dst):
        with torch.cuda.stream(a):
            a.wait_stream(b)
            rc._flagged_hop(lib, src, dst, comp, b)

    def bare(src, dst):
        with torch.cuda.stream(a):
            rc._launch_copy(lib, src, dst)

    times = device_times(rotate(flagged, srcs[:4], dsts), iters)
    bare_times = device_times(rotate(bare, srcs[:4], dsts), iters)
    torch.cuda.synchronize()
    if int(comp.words[2]):
        raise AssertionError("K4 cross-stream completion: a wait timed out")
    hop = (hop_ms + hop_again_ms) / 2
    bare_mean = (bare_ms + bare_again_ms) / 2
    return {"hops": hops, "bit_exact": True,
            "hop_ms": [hop_ms, hop_again_ms],
            "bare_copy_ms": [bare_ms, bare_again_ms],
            "completion_us": 1e3 * (hop - bare_mean),
            "flagged_copy_kernel_ms": k4_copy_ms(times),
            "bare_copy_kernel_ms": k4_copy_ms(bare_times),
            "timed_by": "CUDA events, start on A to end on B after the wait "
                        "(bare: end on A), behind a sleep kernel"}


def phase_kernels_k4():
    """K4 against ``copy_`` on the card: rings of RING_RANKS ranks on
    cuda:0 at the main-path payload (shifts 1 and 3), odd byte counts, the edges of the design, the peer completion forced
    across two streams of one card, and the ring over two cards when
    there are two with peer access.  Returns the main-path row."""
    import torch

    from ray_tpu_torch.ops.cuda import remote_copy as rc

    nbytes = math.prod(ACTIVATION) * 2
    shards = activation_shards()
    dev = shards[0].device
    row = {"phase": "kernel", "kernel": "K4 remote_copy", "case": "main_path",
           "ranks": RING_RANKS, "device": "cuda:0 (every rank)",
           "shape": list(ACTIVATION), "dtype": "bfloat16", "nbytes": nbytes,
           "shifts": list(RING_SHIFTS), "launches_per_ring": [],
           "max_abs_err": 0.0, "compared_with": "copy_, bit-exact",
           "completion": ("flag + wait" if rc.needs_completion(dev, dev)
                          else "stream order"),
           "stages": rc.STAGES, "stage_bytes": rc.STAGE_BYTES,
           "blocks": rc.grid_blocks(nbytes, torch.cuda.get_device_properties(
               0).multi_processor_count)}
    for shift in RING_SHIFTS:
        launches, err = k4_ring_case(shards, shift)
        row["launches_per_ring"].append(launches)
        row["max_abs_err"] = max(row["max_abs_err"], err)
    dsts = [torch.empty_like(x) for x in shards]
    row.update(k4_hop_ms(shards, dsts))
    row["bound_ms"] = 1e3 * 2 * nbytes / PEAK_BYTES
    row["bound_by"] = "bytes"
    row["bound_share"] = (row["bound_ms"] / row["ms"]
                          if isinstance(row["ms"], float) else "not measured")
    if row["launches_per_ring"] != [RING_RANKS] * len(RING_SHIFTS) or \
            not any(K4_KERNEL in n for n in row["design"]):
        raise AssertionError(f"K4 main path: launches "
                             f"{row['launches_per_ring']}, kernels "
                             f"{row['design']}")
    emit(row)
    del dsts
    for dtype, shape in (("float32", (3, 7)), ("int8", (37,))):
        small = activation_shards(shape=shape, dtype=dtype, seed=12)
        launches, err = k4_ring_case(small, 1)
        emit({"phase": "kernel", "kernel": "K4 remote_copy",
              "case": f"odd_bytes_{dtype}", "ranks": RING_RANKS,
              "shape": list(shape), "dtype": dtype,
              "nbytes": small[0].numel() * small[0].element_size(),
              "launches_per_ring": [launches], "max_abs_err": err})
    del shards
    emit({"phase": "kernel", "kernel": "K4 remote_copy", "case": "edges",
          "bit_exact": True, "launches_each": 1, "cases": k4_edge_cases()})
    emit({"phase": "kernel", "kernel": "K4 remote_copy",
          "case": "cross_stream", **k4_cross_stream()})
    emit({"phase": "kernel", "kernel": "K4 remote_copy", "case": "peer_ring",
          **k4_peer_ring()})
    torch.cuda.empty_cache()
    return row


def k4_peer_stress(hops=K4_CROSS_HOPS):
    """``hops`` 16 MiB hops cuda:0 -> cuda:1 through ``remote_copy`` over
    rotating buffers, each consumed by a clone on cuda:1's stream queued
    after the hop's wait; every clone must equal its source.  Returns the
    hops."""
    import torch

    from ray_tpu_torch.ops.cuda.remote_copy import (check_remote_copies,
                                                    remote_copy)

    srcs = activation_shards(n=5, seed=18)
    dsts = [torch.empty_like(x, device="cuda:1") for x in srcs[:4]]
    seen = []
    torch.cuda.synchronize("cuda:0")
    torch.cuda.synchronize("cuda:1")
    for h in range(hops):
        remote_copy(srcs[h % 5], dsts[h % 4])
        with torch.cuda.device(1):
            seen.append(dsts[h % 4].clone())
    torch.cuda.synchronize("cuda:1")
    check_remote_copies()
    wrong = [h for h, got in enumerate(seen)
             if not _same_bits(got.to("cuda:0"), srcs[h % 5])]
    if wrong:
        raise AssertionError(f"K4 cuda:0 -> cuda:1: hops {wrong} differ "
                             "from their source")
    return hops


def k4_peer_ring():
    """The ring over the visible cards (rank i on cuda:i, at most
    RING_RANKS), each hop a store over NVLink, a stress of flagged hops
    onto cuda:1, and the hop cuda:0 -> cuda:1 timed; or why it was not
    run."""
    import torch

    count = min(torch.cuda.device_count(), RING_RANKS)
    if count < 2:
        return {"run": False, "why": f"{count} CUDA device visible; the "
                "peer ring needs two"}
    missing = [(i, j) for i in range(count) for j in range(count)
               if i != j and not torch.cuda.can_device_access_peer(i, j)]
    if missing:
        return {"run": False, "why": f"no peer access between {missing}"}
    nbytes = math.prod(ACTIVATION) * 2
    shards = [x.to(f"cuda:{i}") for i, x in
              enumerate(activation_shards(n=count, seed=13))]
    launches = []
    err = 0.0
    for shift in RING_SHIFTS:
        n, e = k4_ring_case(shards, shift)
        launches.append(n)
        err = max(err, e)
    stressed = k4_peer_stress()
    dsts = [torch.empty_like(shards[0], device="cuda:1")]
    times = k4_hop_ms(shards[:1], dsts)
    return {"run": True, "ranks": count, "shifts": list(RING_SHIFTS),
            "launches_per_ring": launches, "max_abs_err": err,
            "nbytes": nbytes, "timed_hop": "cuda:0 -> cuda:1",
            "stress_hops_bit_exact": stressed, **times,
            "bound_ms": 1e3 * nbytes / PEAK_NVLINK_BYTES,
            "bound_by": "bytes (NVLink, 450 GB/s each way)"}


def tensor_digest(t) -> int:
    """A digest of a tensor's bytes, computed where the tensor lies: the
    sum of its 16-bit words, each times an odd weight that depends on its
    position, in int64 arithmetic that wraps.  Taken in chunks of
    ``DIGEST_CHUNK`` words, so a leaf of gigabytes needs no int64 copy of
    its own size."""
    import torch

    words = t.detach().contiguous().view(torch.int16).reshape(-1)
    total = 0
    for start in range(0, words.numel(), DIGEST_CHUNK):
        w = words[start:start + DIGEST_CHUNK].to(torch.int64)
        weight = torch.arange(start, start + w.numel(),
                              device=w.device) * 2 + 1
        total += int((w * weight).sum())
    return (total + 2 ** 63) % 2 ** 64 - 2 ** 63


def channel_reader(forward, back, writer_info, frames, device):
    """The reader process of the ``channel`` phase: bring CUDA up on
    ``device`` (as a pipeline stage that computes would have it), probe
    and negotiate from its own endpoint info, then land ``frames`` frames
    with ``read_borrowed`` and send their digests back."""
    import torch

    from ray_tpu_torch.experimental.channel.transport import (
        attach_edge_transport, local_endpoint_info, negotiate)

    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
        torch.cuda.init()
    info = local_endpoint_info()
    back.write({"info": info, "tier": negotiate(writer_info, info)},
               timeout=120)
    rd = attach_edge_transport(forward, 0, device=device)
    forward.channel.detach()
    try:
        digests = [rd.read_borrowed(
            lambda v: (v["step"], tensor_digest(v["x"]),
                       str(v["x"].device)), timeout=120)
            for _ in range(frames)]
        back.write({"digests": digests, "stats": rd.stats}, timeout=120)
    finally:
        rd.channel.detach()
        back.channel.detach()


def _wall(fn) -> float:
    """Seconds of ``fn()`` by the host clock, the device synchronised on
    both sides when there is one."""
    import torch

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return time.perf_counter() - t0


def while_alive(proc, op, timeout):
    """``op(1.0)`` (a channel read or write with a one-second deadline)
    retried until it succeeds, for at most ``timeout`` seconds; raises as
    soon as ``proc``, the peer that must answer, has exited."""
    from ray_tpu_torch.experimental.channel import ChannelTimeoutError

    deadline = time.monotonic() + timeout
    while True:
        try:
            return op(1.0)
        except ChannelTimeoutError:
            if proc.exitcode is not None:
                raise AssertionError(f"the reader process exited with code "
                                     f"{proc.exitcode}") from None
            if time.monotonic() > deadline:
                raise


def startup_zygote_probe(conn):
    """The ``startup`` phase's first child: it only makes the zygote
    start, and answers with the zygote's preload record."""
    from ray_tpu_torch._private import worker_zygote

    conn.send(worker_zygote.preload_report())
    conn.close()


def startup_child(conn, device):
    """One child of the ``startup`` phase: its stages in seconds
    (``STARTUP_STAGES`` from ``interpreter`` to ``k1``, the first four
    from this module's stamps when the child imported it), its first K1
    launch against the plain attention, and its parent."""
    t_target = time.time()
    import torch

    from ray_tpu_torch._private import worker_zygote
    from ray_tpu_torch.ops.cuda import flash_attention as fa

    t_imports = time.time()
    created = worker_zygote.proc_start_epoch(os.getpid())
    stages = {"interpreter": _T_MAIN - created, "torch": _T_TORCH - _T_MAIN,
              # the gym adapter this module imports, then K1's wrapper
              "port": _T_PORT - _T_TORCH + t_imports - t_target,
              "entry": t_target - _T_PORT}
    t = {"imports": t_imports}
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.empty(1, device=dev)
        torch.cuda.synchronize()
    t["context"] = time.time()
    if dev.type == "cuda":
        fa._lib()
    t["kernel_lib"] = time.time()
    b, sq, h, d = STARTUP_K1
    gen = torch.Generator().manual_seed(24)
    q, k, v = (torch.randn(b, sq, h, d, generator=gen).to(
        torch.bfloat16).to(dev) for _ in range(3))
    launches = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t["k1"] = time.time()
    for a, b in zip(("imports", "context", "kernel_lib"),
                    ("context", "kernel_lib", "k1")):
        stages[b] = t[b] - t[a]
    launches = fa.flash_attention_fwd.launches - launches
    pout, plse = fa.flash_attention_plain(q, k, v, causal=True)
    err_o = (out.float() - pout.float()).abs()
    conn.send({"stages": stages, "created": created, "k1_done": t["k1"],
               "pid": os.getpid(), "ppid": os.getppid(),
               "device": str(out.device), "k1_launches": launches,
               "max_abs_err": float(err_o.max()),
               "lse_max_abs_err": float((lse - plse).abs().max()),
               "within_tol": bool((err_o <= 2e-2 + 2e-2 * pout.float().abs())
                                  .all()) and float((lse - plse).abs().max())
               <= 1e-3})
    conn.close()


def start_children(n, device, timeout=300):
    """``n`` ``startup_child`` processes of ``worker_zygote.get_context()``
    started together; each one's reply with the parent's stamps (``start``
    just before its ``start()``, ``reply`` when its answer arrived) and
    its stage durations in seconds."""
    from multiprocessing.connection import wait

    from ray_tpu_torch._private import worker_zygote

    ctx = worker_zygote.get_context()
    kids = []
    try:
        for _ in range(n):
            parent, child = ctx.Pipe(duplex=False)
            proc = ctx.Process(target=startup_child, daemon=True,
                               args=(child, device))
            t_start = time.time()
            proc.start()
            child.close()
            kids.append({"proc": proc, "conn": parent, "start": t_start})
        replies = {}
        deadline = time.monotonic() + timeout
        while len(replies) < n:
            left = deadline - time.monotonic()
            ready = wait([k["conn"] for k in kids if id(k) not in replies],
                         max(0.0, left))
            if not ready:
                raise AssertionError(f"startup: {n - len(replies)} children "
                                     f"did not answer within {timeout} s")
            for kid in kids:
                if kid["conn"] in ready:
                    try:
                        got = kid["conn"].recv()
                    except EOFError:
                        raise AssertionError(
                            f"startup: child pid {kid['proc'].pid} exited "
                            f"(code {kid['proc'].exitcode}) without "
                            "answering") from None
                    replies[id(kid)] = {**got, "reply": time.time(),
                                        "start": kid["start"]}
        out = []
        for kid in kids:
            r = replies[id(kid)]
            r["stages_s"] = {"process": r["created"] - r["start"],
                             **r["stages"],
                             "reply": r["reply"] - r["k1_done"]}
            r["total_s"] = r["reply"] - r["start"]
            out.append(r)
            kid["proc"].join(30)
        return out
    finally:
        for kid in kids:
            kid["conn"].close()
            if kid["proc"].is_alive():
                kid["proc"].kill()
                kid["proc"].join(10)


def startup_split(children):
    """Median and range of each stage and of the total over ``children``."""
    import statistics

    rows = {st: [c["stages_s"][st] for c in children]
            for st in STARTUP_STAGES}
    rows["total"] = [c["total_s"] for c in children]
    return {st: {"median_s": statistics.median(v), "min_s": min(v),
                 "max_s": max(v)} for st, v in rows.items()}


def phase_startup(device="cuda:0", n=STARTUP_CHILDREN):
    """Process start-up split by stage, through the worker zygote and cold
    (``RAY_TPU_TORCH_USE_WORKER_ZYGOTE=0``): see the module's docstring.
    ``stages`` per method: ``process`` from ``start()`` to the child's
    creation (its kernel start time, 10 ms ticks), ``interpreter`` to the
    start of this module's re-import there (a cold child's interpreter;
    a forked one's environment and paths), ``torch`` its ``import
    torch``, ``port`` its imports of the port (the gym adapter at this
    module's top, K1's wrapper in the target), ``entry`` the rest of the
    module and the unpickling of its target, ``context`` its CUDA
    context, ``kernel_lib`` K1's library's load, ``k1`` its first K1
    synchronised, ``reply`` from there to its answer here (the plain
    attention's check included)."""
    import torch

    from ray_tpu_torch._private import worker_zygote

    ctx = worker_zygote.get_context()
    parent, child = ctx.Pipe(duplex=False)
    probe = ctx.Process(target=startup_zygote_probe, args=(child,),
                        daemon=True)
    t0 = time.time()
    probe.start()
    child.close()
    if not parent.poll(300):
        raise AssertionError("startup: the zygote forked no child in 300 s")
    zy = parent.recv()  # the zygote's preload record, as it forked the probe
    first_start_s = time.time() - t0
    probe.join(30)
    zygote_pid = worker_zygote.stats()["zygote_pid"]
    forked = start_children(n, device)
    key = "RAY_TPU_TORCH_USE_WORKER_ZYGOTE"
    old = os.environ.get(key)
    os.environ[key] = "0"
    try:
        cold = start_children(n, device)
    finally:
        if old is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = old
    faults = []
    want_dev = str(torch.device(device))
    for method, kids, parent_pid in (("zygote", forked, zygote_pid),
                                     ("spawn", cold, os.getpid())):
        for c in kids:
            if c["ppid"] != parent_pid:
                faults.append(f"{method} child {c['pid']}: parent "
                              f"{c['ppid']}, expected {parent_pid}")
            if c["device"] != want_dev or c["k1_launches"] != (
                    1 if want_dev.startswith("cuda") else 0):
                faults.append(f"{method} child {c['pid']}: K1 on "
                              f"{c['device']}, {c['k1_launches']} launches")
            if not c["within_tol"]:
                faults.append(f"{method} child {c['pid']}: K1 off its plain "
                              f"version by {c['max_abs_err']} (lse "
                              f"{c['lse_max_abs_err']})")
    if zy.get("pid") != zygote_pid or zy.get("threads") != 1 \
            or zy.get("cuda_initialized") is not False:
        faults.append(f"the zygote's preload record {zy}")
    if faults:
        raise AssertionError("startup: " + "; ".join(faults))
    split = {"zygote": startup_split(forked), "spawn": startup_split(cold)}
    return {
        "children_per_method": n, "device": want_dev,
        "k1_shape": dict(zip("bshd", STARTUP_K1)), "dtype": "bfloat16",
        "zygote_first_start_s": first_start_s,
        "zygote_preload": {
            "interpreter_s": zy["preload_start"] - zy["created"],
            "preload_s": zy["preload_s"],
            "created_to_ready_s": zy["ready"] - zy["created"],
            "threads": zy["threads"],
            "cuda_initialized": zy["cuda_initialized"],
            "modules": len(zy["loaded"]), "failed": zy["failed"]},
        "stages_s": split,
        "total_median_s": {m: split[m]["total"]["median_s"] for m in split},
        "k1_launches": sum(c["k1_launches"] for c in forked + cold),
        "k1_max_abs_err": max(c["max_abs_err"] for c in forked + cold),
        "children": {"zygote": [{"pid": c["pid"], "ppid": c["ppid"],
                                 **c["stages_s"]} for c in forked],
                     "spawn": [{"pid": c["pid"], "ppid": c["ppid"],
                                **c["stages_s"]} for c in cold]}}


def phase_channel(device="cuda:0", frames=CHANNEL_FRAMES):
    """A device-tier edge between this process and a reader forked by the
    worker zygote on the same card: ``frames`` activations written through
    ``make_edge_transport`` (sized as the compiled DAG sizes a channel for
    a 16 MiB payload: + 256 bytes of frame slack), landed by the reader,
    digests compared.  Returns times, tiers and stats."""
    import torch

    from ray_tpu_torch._private import worker_zygote

    from ray_tpu_torch._private.shm import open_shm
    from ray_tpu_torch.experimental.channel.transport import (
        TIER_DEVICE, TIER_HOST, attach_edge_transport, local_endpoint_info,
        make_edge_transport, negotiate)

    nbytes = math.prod(ACTIVATION) * 2
    xs = activation_shards(device=device, n=frames, seed=14)
    want = [(k, tensor_digest(x)) for k, x in enumerate(xs)]
    writer_info = local_endpoint_info()
    fwd = make_edge_transport(tier=TIER_DEVICE, buffer_size=nbytes + 256,
                              edge="stage0->stage1")
    back = make_edge_transport(tier=TIER_HOST, buffer_size=1 << 16,
                               edge="stage1->stage0")
    reply = attach_edge_transport(back, 0, device=device)
    proc = worker_zygote.get_context().Process(
        target=channel_reader, daemon=True,
        args=(fwd, back, writer_info, frames, str(torch.device(device))))
    names = [fwd.name, back.name]
    try:
        t0 = time.perf_counter()
        proc.start()
        hello = while_alive(proc, reply.read, 180)
        reader_up_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for k, x in enumerate(xs):
            while_alive(proc, lambda t: fwd.write({"x": x, "step": k},
                                                  timeout=t), 120)
        done = while_alive(proc, reply.read, 120)
        wall_s = time.perf_counter() - t0
        proc.join(timeout=60)
        exitcode = proc.exitcode
    finally:
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=10)
        reply.channel.detach()
        fwd.destroy()
        back.destroy()
    left = []
    for name in names:
        try:
            open_shm(name=name).close()
            left.append(name)
        except FileNotFoundError:
            pass
    got = [(k, d) for k, d, _ in done["digests"]]
    tiers = {"writer": negotiate(writer_info, hello["info"]),
             "reader": hello["tier"]}
    faults = []
    if exitcode != 0:
        faults.append(f"reader exit code {exitcode}")
    if got != want:
        faults.append(f"digests {got} != {want}")
    if tiers != {"writer": TIER_DEVICE, "reader": TIER_DEVICE}:
        faults.append(f"tiers {tiers}")
    if fwd.stats["device_frames"] != frames or fwd.stats["degraded"] \
            or done["stats"]["degraded"]:
        faults.append(f"writer stats {fwd.stats}, reader stats "
                      f"{done['stats']}")
    if left:
        faults.append(f"segments not destroyed: {left}")
    if faults:
        raise AssertionError("channel: " + "; ".join(faults))
    return {"frames": frames, "frame_bytes": nbytes,
            **frame_copies_ms(xs[0], xs[1]),
            "buffer_size": nbytes + 256, "tiers": tiers,
            "writer_info": dataclasses.asdict(writer_info),
            "reader_info": dataclasses.asdict(hello["info"]),
            "landed_on": sorted({dev for _, _, dev in done["digests"]}),
            "ms_per_frame": 1e3 * wall_s / frames,
            "gb_per_s": frames * nbytes / wall_s / 1e9,
            "writer_ms_per_frame": 1e3 * fwd.stats["write_wait_s"] / frames,
            "reader_ms_per_frame": 1e3 * done["stats"]["read_wait_s"]
            / frames,
            "reader_start_s": reader_up_s, "digests_equal": True,
            "writer_stats": fwd.stats, "reader_stats": done["stats"],
            "segments_destroyed": names}


def frame_copies_ms(x, out):
    """Where a frame's time goes: each copy that one frame of ``x`` makes,
    timed alone in this process (best of three): the writer's pageable D2H
    (``.cpu()``), its memcpy into a segment, a pageable H2D, and the
    reader's landing, an H2D into ``out`` from a page-locked segment."""
    import numpy as np
    import torch

    from ray_tpu_torch.experimental.channel import Channel

    def best(fn):
        return 1e3 * min(_wall(fn) for _ in range(3))

    nbytes = x.numel() * x.element_size()
    host = x.cpu()
    raw = host.reshape(-1).view(torch.uint8).numpy()
    seg = Channel(buffer_size=nbytes)
    try:
        shm = np.frombuffer(seg._payload(nbytes), np.uint8)
        row = {"d2h_ms": best(lambda: x.cpu()),
               "shm_write_ms": best(lambda: np.copyto(shm, raw)),
               "h2d_ms": best(lambda: out.copy_(host))}
        seg.pin_for_cuda()
        landing = torch.frombuffer(seg._payload(nbytes), dtype=x.dtype)
        row["h2d_pinned_ms"] = best(
            lambda: out.view(-1).copy_(landing, non_blocking=True))
        del shm, landing
    finally:
        seg.destroy()
    return row


def phase_ring(device="cuda"):
    """The in-process device hop at the main-path payload: RING_RANKS
    ranks' activations around the ring through ``device_ring_copy``,
    shifts 1 and 3, each ring ended by a synchronize, the K4 count set to
    0 just before and read just after; each result must equal the shifted
    input.  Then the host's split per ring, from RING_SPLIT_RINGS more
    calls of ``device_ring_copy`` (after RING_SPLIT_WARMUP, so the
    allocator has the buffers): the time in its K4 launches and in its
    ``check_remote_copies``, each timed around the call that
    ``device_ring_copy`` makes, the rest of the call (allocations, the
    loop), and the wait for the card after it."""
    import torch

    from ray_tpu_torch.experimental.channel import transport
    from ray_tpu_torch.ops.cuda.remote_copy import remote_copy

    shards = activation_shards(device=device, seed=15)
    torch.cuda.synchronize()
    remote_copy.launches = 0
    t0 = time.perf_counter()
    outs = []
    for s in RING_SHIFTS:
        outs.append(transport.device_ring_copy(shards, shift=s))
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = remote_copy.launches
    for shift, out in zip(RING_SHIFTS, outs):
        for i, x in enumerate(shards):
            if not _same_bits(out[(i + shift) % RING_RANKS], x):
                raise AssertionError(f"ring shift {shift}: rank "
                                     f"{(i + shift) % RING_RANKS} does not "
                                     f"hold rank {i}'s tensor")
    if launches != RING_RANKS * len(RING_SHIFTS):
        raise AssertionError(f"K4 launched {launches} times in "
                             f"{len(RING_SHIFTS)} rings of {RING_RANKS}")
    split = {"launch": 0.0, "check": 0.0, "call": 0.0, "sync": 0.0}

    def timed(key, fn):
        def call(*args):
            t0 = time.perf_counter()
            fn(*args)
            split[key] += time.perf_counter() - t0
        return call

    real = transport.remote_copy, transport.check_remote_copies
    transport.remote_copy = timed("launch", real[0])
    transport.check_remote_copies = timed("check", real[1])
    try:
        for r in range(RING_SPLIT_WARMUP + RING_SPLIT_RINGS):
            if r == RING_SPLIT_WARMUP:
                split.update(dict.fromkeys(split, 0.0))
            t0 = time.perf_counter()
            transport.device_ring_copy(
                shards, shift=RING_SHIFTS[r % len(RING_SHIFTS)])
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            split["call"] += t1 - t0
            split["sync"] += time.perf_counter() - t1
    finally:
        transport.remote_copy, transport.check_remote_copies = real
    ms = {k: 1e3 * v / RING_SPLIT_RINGS for k, v in split.items()}
    return {"ranks": RING_RANKS, "shifts": list(RING_SHIFTS),
            "shape": list(ACTIVATION), "dtype": "bfloat16",
            "k4_launches": launches, "wall_ms_per_ring":
            1e3 * wall_s / len(RING_SHIFTS),
            "host_split_ms_per_ring": {
                "launch": ms["launch"], "check": ms["check"],
                "rest": ms["call"] - ms["launch"] - ms["check"],
                "sync": ms["sync"]},
            "host_split_rings": RING_SPLIT_RINGS}


def cards_ms(fn, devices, iters=MESH_GROUP_ITERS) -> float:
    """Mean device span per call of ``fn`` over several cards: CUDA events
    on each card's current stream around ``iters`` calls after a
    warm-up; the longest card's."""
    import torch

    fn()
    for d in devices:
        torch.cuda.synchronize(d)
    ends = []
    for d in devices:
        with torch.cuda.device(d):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            ends.append((d, start))
    for _ in range(iters):
        fn()
    spans = []
    for d, start in ends:
        with torch.cuda.device(d):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            spans.append(start.elapsed_time(end) / iters)
    return max(spans)


def bus_gbps(op, nbytes, n, ms):
    """NCCL-tests' bus bandwidth of one call: ``nbytes`` (a rank's input;
    allgather: its output) over ``ms``, times 2(n-1)/n for allreduce and
    (n-1)/n for allgather and reducescatter; a permute's hop and a
    broadcast move the bytes once."""
    factor = {"allreduce": 2 * (n - 1) / n, "allgather": (n - 1) / n,
              "reducescatter": (n - 1) / n}.get(op, 1.0)
    return nbytes / (ms * 1e-3) / 1e9 * factor


def integer_values(devices, numel, seed):
    """Integer-valued fp32 in [-3, 3] (zeros included), one tensor of
    ``numel`` per card: every sum, max, min and product of four is exact
    in fp32."""
    import torch

    gen = torch.Generator(device=devices[0]).manual_seed(seed)
    return [torch.randint(-3, 4, (numel,), generator=gen,
                          device=devices[0]).float().to(d)
            for d in devices]


def _rows_same_bits(got, want, what):
    """Each rank's tensor (on its card) bit-equal to the plain version's
    row (on the host)."""
    bad = [i for i, (g, w) in enumerate(zip(got, want))
           if not _same_bits(g.cpu(), w)]
    if bad:
        raise AssertionError(f"{what}: ranks {bad} differ from the plain "
                             "version")


def drive_mesh_group(group, devices, seed=21):
    """Every op of a mesh group over ``devices`` once, held against its
    plain version: allreduce of SUM, MAX, MIN and PRODUCT and reduce on
    integer-valued fp32 (exact), broadcast from each rank, allgather and
    every permutation of ``mesh_perms`` on the main-path activation
    (bit-exact), reducescatter of integer-valued fp32 (exact), barrier.
    K4's count is set to 0 just before and read just after.  Then each
    op timed (``cards_ms``) with its bus GB/s."""
    import torch

    from ray_tpu_torch.ops.cuda.remote_copy import remote_copy
    from ray_tpu_torch.util.collective.collective_group import (
        mesh_group as mg)
    from ray_tpu_torch.util.collective.types import ReduceOp

    n = len(devices)
    acts = [x.to(d) for x, d in zip(activation_shards(
        device=devices[0], n=n, seed=seed), devices)]
    ints = integer_values(devices, MESH_GROUP_INT_NUMEL, seed + 1)
    scatter_in = [x.view(n, -1) for x in ints]
    perms = mesh_perms(n)
    for d in devices:
        torch.cuda.synchronize(d)
    remote_copy.launches = 0
    for op in MESH_GROUP_REDUCE_OPS:
        want = mg.allreduce_plain(ints, ReduceOp(op))
        _rows_same_bits(group.allreduce(ints, ReduceOp(op)), [want] * n,
                        f"allreduce {op}")
    _rows_same_bits(group.reduce(ints, 0), [mg.allreduce_plain(ints)] * n,
                    "reduce")
    for src in range(n):
        _rows_same_bits(group.broadcast(acts, src),
                        mg.broadcast_plain(acts, src), f"broadcast {src}")
    _rows_same_bits(group.allgather(acts), [mg.allgather_plain(acts)] * n,
                    "allgather")
    _rows_same_bits(group.reducescatter(scatter_in),
                    mg.reducescatter_plain(scatter_in), "reducescatter")
    group.barrier()
    for perm in perms:
        _rows_same_bits(group.permute(acts, perm),
                        mg.permute_plain(acts, perm), f"permute {perm}")
    for d in devices:
        torch.cuda.synchronize(d)
    launches = remote_copy.launches
    pairs = sum(len(p) for p in perms)
    if launches != pairs:
        raise AssertionError(f"mesh group: K4 launched {launches} times for "
                             f"{pairs} permute pairs")
    act_bytes = acts[0].numel() * acts[0].element_size()
    int_bytes = ints[0].numel() * 4
    timed = {
        "allreduce_sum": ("allreduce", int_bytes,
                          lambda: group.allreduce(ints)),
        "broadcast": ("broadcast", act_bytes,
                      lambda: group.broadcast(acts, 0)),
        "allgather": ("allgather", n * act_bytes,
                      lambda: group.allgather(acts)),
        "reducescatter": ("reducescatter", int_bytes,
                          lambda: group.reducescatter(scatter_in)),
        "permute_ring1": ("permute", act_bytes,
                          lambda: group.permute(acts, perms[0]))}
    ops = {}
    for name, (op, nbytes, fn) in timed.items():
        ms = cards_ms(fn, devices)
        ops[name] = {"ms": ms, "payload_bytes": nbytes,
                     "bus_gbps": bus_gbps(op, nbytes, n, ms)}
    return {"ranks": n, "devices": [str(d) for d in devices],
            "activation": list(ACTIVATION), "activation_dtype": "bfloat16",
            "int_numel": MESH_GROUP_INT_NUMEL,
            "checked": {"allreduce": list(MESH_GROUP_REDUCE_OPS),
                        "reduce": True, "broadcast_sources": n,
                        "allgather": True, "reducescatter": True,
                        "barrier": True,
                        "permutes": [list(map(list, p)) for p in perms]},
            "exact": "every op bit-equal to its plain version",
            "k4_launches": launches, "k4_pairs": pairs, "ops": ops}


def mesh_perms(n):
    """The permutations a mesh group of ``n`` ranks is held to: ring
    shifts 1 and 3 (over one rank, the rank onto itself) and, over four,
    ``MESH_GROUP_PARTIAL``."""
    if n == 1:
        return [((0, 0),)]
    perms = [tuple((i, (i + s) % n) for i in range(n)) for s in RING_SHIFTS]
    return perms + ([MESH_GROUP_PARTIAL] if n == 4 else [])


class MeshOwner:
    """The compiled DAG's mesh owner (``mesh_group``, ``mesh_group4``): one
    actor process whose cards are the ranks of its mesh group
    (``allreduce.bind([s], backend="mesh")``)."""

    def __init__(self, numel):
        self.numel = numel

    def shards(self, step):
        """Card i's value ``i + 1 + step``, on card i."""
        import torch

        return [torch.full((self.numel,), float(i + 1 + step),
                           device=f"cuda:{i}")
                for i in range(torch.cuda.device_count())]

    def consume(self, reduced):
        """What reached this method: live tensors, their cards and
        values, and the group's class under its supervision wrapper."""
        import torch

        from ray_tpu_torch.util.collective.collective import _group_mgr

        return {"tensors": all(isinstance(t, torch.Tensor)
                               for t in reduced),
                "devices": [str(t.device) for t in reduced],
                "min_max": [[float(t.min()), float(t.max())]
                            for t in reduced],
                "groups": sorted({type(g._inner).__name__
                                  for g in _group_mgr._groups.values()})}


def dag_mesh_owner(execs=MESH_GROUP_DAG_EXECS):
    """``shards -> allreduce(backend="mesh") -> consume`` compiled over one
    ``MeshOwner`` on the card, which sees every card: each execution's
    reduced value must reach ``consume`` as one CUDA tensor per card, each
    equal to the exact sum."""
    from ray_tpu_torch import actor
    from ray_tpu_torch.dag import InputNode, allreduce

    t0 = time.perf_counter()
    owner = actor.ActorClass(MeshOwner).remote(MESH_GROUP_DAG_NUMEL)
    try:
        actor.get(owner._ready, timeout=300)
        startup_s = time.perf_counter() - t0
        with InputNode() as inp:
            (r,) = allreduce.bind([owner.shards.bind(inp)], backend="mesh")
            dag = owner.consume.bind(r)
        cdag = dag.experimental_compile(submit_timeout=300)
        try:
            outs, exec_ms = [], []
            for step in range(execs):
                t1 = time.perf_counter()
                outs.append(cdag.execute(step).get(timeout=300))
                exec_ms.append(1e3 * (time.perf_counter() - t1))
        finally:
            cdag.teardown()
    finally:
        actor.kill(owner)
    n = len(outs[0]["devices"])
    for step, out in enumerate(outs):
        want = n * (n + 1) / 2 + n * step
        if not out["tensors"] or out["devices"] != [
                f"cuda:{i}" for i in range(n)] or any(
                mm != [want, want] for mm in out["min_max"]) or                 out["groups"] != ["CudaMeshGroup"]:
            raise AssertionError(f"dag mesh owner execution {step}: {out}, "
                                 f"expected {want} on each of {n} cards")
    return {"cards": n, "executions": execs,
            "numel_per_card": MESH_GROUP_DAG_NUMEL, "dtype": "float32",
            "owner_startup_s": startup_s, "exec_ms": exec_ms,
            "exact": True, "group": outs[0]["groups"][0]}


def phase_mesh_group(device="cuda:0"):
    """The single-process group through the collective front on one card
    (``init_collective_group(1, 0, backend="mesh")``, world 1): every op
    against its plain version, ``permute [(0, 0)]`` as one K4 hop
    (``drive_mesh_group``), then the DAG mesh owner."""
    import torch

    from ray_tpu_torch.util.collective import collective as coll

    name = "chip_mesh_group"
    coll.init_collective_group(1, 0, backend="mesh", group_name=name,
                               devices=[device])
    try:
        group = coll._group_mgr.get(name)
        out = drive_mesh_group(group, [torch.device(device)])
        out["group"] = type(group._inner).__name__
    finally:
        coll.destroy_collective_group(name)
    out["dag_mesh_owner"] = dag_mesh_owner()
    return out


def layer_grads(devices, seed=31):
    """One Llama-2-7B layer's gradient leaves in fp32 (random, from
    ``seed``), one copy of each per card: {name: [tensor per card]}."""
    import torch

    from ray_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.llama2_7b()
    h, m = cfg.hidden_size, cfg.mlp_dim
    shapes = {"wq": (h, h), "wk": (h, h), "wv": (h, h), "wo": (h, h),
              "w_gate": (h, m), "w_up": (h, m), "w_down": (m, h),
              "attn_norm": (h,), "mlp_norm": (h,)}
    out = {}
    for name, shape in shapes.items():
        leaves = []
        for d in devices:
            gen = torch.Generator(device=d).manual_seed(seed)
            seed += 1
            leaves.append(torch.randn(shape, generator=gen, device=d))
        out[name] = leaves
    return out


def fp32_sum_misses(got, shards):
    """Elements of ``got`` (tensors of the sum's shape) outside the fp32
    summation bound of the host's sum of ``shards``: two sums of n terms
    in any order differ by at most 2 (n - 1) 2^-24 sum |x_i|."""
    import torch

    n = len(shards)
    host = [s.cpu() for s in shards]
    want = host[0].clone()
    mags = host[0].abs()
    for x in host[1:]:
        want += x
        mags += x.abs()
    bound = 2 * (n - 1) * 2.0 ** -24 * mags
    misses = 0
    for g in got:
        g = g.cpu()
        if g.shape != want.shape:
            raise AssertionError(f"a sum of shape {tuple(g.shape)}, "
                                 f"expected {tuple(want.shape)}")
        misses += int(((g - want).abs() > bound).sum())
    return misses


def phase_mesh_group4():
    """One process owns four cards (``init_collective_group(1, 0,
    backend="mesh")`` over every visible card): ``drive_mesh_group`` on
    the four (permute rings 1 and 3 and a partial permutation,
    broadcast from each card and allgather on the activation,
    bit-exact; the reductions exact; K4 launches equal to the pairs),
    allreduce SUM and reducescatter of one Llama-2-7B layer's fp32
    gradient leaves against the host's fp32 sum, K4 per peer hop beside
    ``copy_`` between the same cards, and the DAG mesh owner over the
    four cards."""
    import torch

    from ray_tpu_torch.util.collective import collective as coll

    t_phase = time.perf_counter()
    n = torch.cuda.device_count()
    name = "chip_mesh_group4"
    coll.init_collective_group(1, 0, backend="mesh", group_name=name)
    try:
        group = coll._group_mgr.get(name)
        devices = list(group.devices)
        if len(devices) != n or group.world_size != n:
            raise AssertionError(f"mesh group over {devices}, {n} cards")
        out = drive_mesh_group(group, devices)
        grads = layer_grads(devices)
        leaves = list(grads.values())
        nbytes = sum(v[0].numel() * 4 for v in leaves)
        reduced = [group.allreduce(v) for v in leaves]
        scattered = [group.reducescatter([t.view(n, -1) for t in v])
                     for v in leaves]
        misses = {"allreduce": 0, "reducescatter": 0}
        for v, r, sc in zip(leaves, reduced, scattered):
            misses["allreduce"] += fp32_sum_misses(r, v)
            rows = [x.view(n, -1) for x in v]
            for i in range(n):
                misses["reducescatter"] += fp32_sum_misses(
                    [sc[i]], [x[i] for x in rows])
        del reduced, scattered
        ar_ms = cards_ms(lambda: [group.allreduce(v) for v in leaves],
                         devices, iters=3)
        rs_ms = cards_ms(lambda: [group.reducescatter(
            [t.view(n, -1) for t in v]) for v in leaves], devices, iters=3)
        out["layer_grads"] = {
            "model": "llama2_7b", "leaves": list(grads),
            "bytes_per_card": nbytes, "dtype": "float32",
            "tolerance": "2 (n-1) 2^-24 sum|x_i| per element (fp32 sums "
                         "of n terms in two orders)",
            "elements_outside": misses,
            "allreduce_ms": ar_ms,
            "allreduce_bus_gbps": bus_gbps("allreduce", nbytes, n, ar_ms),
            "reducescatter_ms": rs_ms,
            "reducescatter_bus_gbps": bus_gbps("reducescatter", nbytes, n,
                                               rs_ms)}
        del grads, leaves
        if any(misses.values()):
            raise AssertionError(f"mesh_group4 layer grads: {misses}")
    finally:
        coll.destroy_collective_group(name)
    torch.cuda.empty_cache()
    acts = activation_shards(n=n, seed=23)
    out["k4_peer_hops"] = {}
    for i, j in mesh_perms(n)[0]:
        src = acts[i].to(devices[i])
        dst = torch.empty_like(src, device=devices[j])
        hop = k4_hop_ms([src], [dst])
        out["k4_peer_hops"][f"{i}->{j}"] = {
            k: hop[k] for k in ("ms", "ms_again", "copy_kernel_ms",
                                "wait_kernel_ms", "plain_ms", "library_ms",
                                "hop_wall_ms")}
    out["dag_mesh_owner"] = dag_mesh_owner()
    if out["dag_mesh_owner"]["cards"] != n:
        raise AssertionError(f"dag mesh owner over "
                             f"{out['dag_mesh_owner']['cards']} cards")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def mesh_group4_or_why():
    import torch

    if torch.cuda.device_count() < MESH4_RANKS:
        return {"ran": False, "why": (
            f"{torch.cuda.device_count()} card(s) present; the phase needs "
            f"{MESH4_RANKS}")}
    return phase_mesh_group4()


def small_model(device="cuda"):
    """The fp32 model of ``small_reference`` (head_dim 64), seed 1."""
    from ray_tpu_torch.models.llama import LlamaConfig, llama_init

    cfg = LlamaConfig.tiny(hidden_size=256, num_heads=4, num_kv_heads=2,
                           max_seq_len=512)
    return cfg, llama_init(cfg, seed=1, device=device)


def phase_small_reference(device="cuda"):
    """Small fp32 models on the card against a plain reference: logits
    through K1 against the reference attention (fp32 sums in another
    order: 1e-4), greedy engine tokens against full-recompute argmax
    (token-exact), the serving options held exact in fp32
    (``SERVING_OPTION_CHECKS``), three train steps, and a small MoE's
    forward and three train steps (``small_moe_reference``)."""
    import torch

    from ray_tpu_torch.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import llama_apply

    cfg, params = small_model(device)
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
    options = {name: check(cfg, params, device)
               for name, check in SERVING_OPTION_CHECKS.items()}
    return {"forward_k1_vs_ref_max_abs": fwd_err,
            "engine_tokens_checked": sum(len(o.token_ids) for o in outs),
            "serving_options": options, **small_train_reference(device),
            "mesh": small_mesh_reference(device),
            "moe": small_moe_reference(device)}


def _greedy_tokens(eng, prompts, max_tokens):
    from ray_tpu_torch.llm import SamplingParams

    outs = eng.generate(prompts, SamplingParams(temperature=0.0,
                                                max_tokens=max_tokens))
    eng.blocks.assert_integrity()
    if any(o.error is not None for o in outs):
        raise AssertionError([o.error for o in outs])
    return [o.token_ids for o in outs]


# bf16 on the card is not token-exact between GEMM shapes (a verify pass
# of B·(G+1) rows, a prefill chunk), so the serving options are held
# exact here, in fp32; at 7B bf16 ``serve_options`` reports agreement.
def check_spec_engine(cfg, params, device="cuda"):
    """``spec_tokens=4``: the same greedy tokens as the plain engine, with
    at least one verify pass."""
    from ray_tpu_torch.llm import LLMEngine

    prompts = [[5, 9, 5, 9, 5, 9], [7, 1, 2, 8, 4], [3, 4, 3, 4, 3, 4],
               [42, 42, 42]]
    kw = dict(batch_slots=4, max_len=128, decode_window=1, device=device)
    plain = _greedy_tokens(LLMEngine(cfg, params, **kw), prompts, 40)
    eng = LLMEngine(cfg, params, spec_tokens=4, **kw)
    spec = _greedy_tokens(eng, prompts, 40)
    if spec != plain:
        raise AssertionError(f"speculative engine {spec} != plain {plain}")
    if not eng.spec_stats["verify_steps"]:
        raise AssertionError(f"no verify pass: {eng.spec_stats}")
    return dict(eng.spec_stats)


def check_chunked_prefill(cfg, params, device="cuda"):
    """``prefill_chunk=32``: the same greedy tokens as unchunked prefill,
    with chunks prefilled."""
    from ray_tpu_torch.llm import LLMEngine

    long = [(7 * k + 3) % cfg.vocab_size for k in range(150)]
    prompts = [long, [5, 9, 2], long[:40]]
    kw = dict(batch_slots=2, max_len=256, block_size=16, device=device)
    plain = _greedy_tokens(LLMEngine(cfg, params, **kw), prompts, 8)
    eng = LLMEngine(cfg, params, prefill_chunk=32, **kw)
    chunked = _greedy_tokens(eng, prompts, 8)
    if chunked != plain:
        raise AssertionError(f"chunked {chunked} != unchunked {plain}")
    if not eng.prefill_stats["chunks"]:
        raise AssertionError("no chunk was prefilled")
    return {"chunks": eng.prefill_stats["chunks"]}


def check_int8_folded(cfg, params, device="cuda"):
    """One int8 decode step through the scale-folded attend against the
    same step through eager dequantization: within the reference's own
    2e-2 (``|folded - eager| <= 2e-2 + 2e-2 |eager|``)."""
    import torch

    from ray_tpu_torch.models import paged_generation as pg

    def ints(values):
        return torch.tensor(values, dtype=torch.int32, device=device)

    pool = pg.init_kv_pool(cfg, 16, 8, kv_dtype="int8", device=device)
    tables = ints([[1, 2, 3] + [0] * 5])
    for pos in range(20):
        _, pool = pg.paged_decode_step(params, ints([(7 * pos + 5) % 250]),
                                       ints([pos]), tables, pool, cfg)
    logits = {}
    saved = pg.INT8_FOLD_MIN_CONTEXT
    try:
        for path, threshold in (("eager", 1 << 30), ("folded", 1)):
            pg.INT8_FOLD_MIN_CONTEXT = threshold
            logits[path], _ = pg.paged_decode_step(
                params, ints([11]), ints([20]), tables,
                {n: t.clone() for n, t in pool.items()}, cfg)
    finally:
        pg.INT8_FOLD_MIN_CONTEXT = saved
    diff = (logits["folded"] - logits["eager"]).abs()
    if bool((diff > 2e-2 + 2e-2 * logits["eager"].abs()).any()):
        raise AssertionError(f"int8 folded vs eager: max |d| "
                             f"{float(diff.max())}")
    return {"folded_vs_eager_max_abs": float(diff.max())}


def check_generate_speculative(cfg, params, device="cuda"):
    """Dense ``generate(speculative=4)``: the same tokens as greedy
    ``generate``."""
    from ray_tpu_torch.models.generation import SamplingParams, generate

    prompts = [[5, 9, 5, 9, 5, 9], [7, 1, 2, 8, 4], [3, 4, 3, 4, 3]]
    sp = SamplingParams(temperature=0.0, max_tokens=24)
    greedy = generate(params, cfg, prompts, sp)
    spec = generate(params, cfg, prompts, sp, speculative=4)
    if spec != greedy:
        raise AssertionError(f"generate(speculative=4) {spec} != greedy "
                             f"{greedy}")
    return {"tokens": sum(map(len, spec))}


def handoff_edge(channel_bytes, device="cuda"):
    """One ``KVBlockShipper`` -> ``KVLandingStrip`` edge in this process
    whose peer is probed as another process (another pid: the tier that
    two CUDA processes of one node negotiate), landing frames on
    ``device``.  The engine is not thread-safe, so the strip's thread only
    queues each landed handoff and the thread that steps the decode
    engine adopts it.  A CUDA reader's mapping of the segment is
    page-locked here, before any request, so that no landing pays for
    it.  Each frame's time on the edge is split into spans, by
    wrapping the functions the transports call until ``close_edge``:
    ``serialize`` (the writer's pickling with its D2H of every tensor),
    ``segment_write`` (the memcpy into the segment) and ``land`` (the
    reader's decoding with its H2D copies, synchronised).  Returns a
    dict: shipper, strip, reader, inbox, spans, pin_s."""
    import queue

    from ray_tpu_torch._private import serialization
    from ray_tpu_torch.experimental.channel.transport import (
        attach_edge_transport, local_endpoint_info)
    from ray_tpu_torch.llm import KVBlockShipper, KVLandingStrip

    spans = {"serialize": [], "segment_write": [], "land": []}

    def timed(fn, span):
        def run(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                spans[span].append(time.perf_counter() - t0)
        return run

    inbox = queue.Queue()
    edge = {"inbox": inbox, "pin_s": 0.0, "spans": spans,
            "unwrap": (serialization.serialize_parts,
                       serialization.write_parts),
            "strip": KVLandingStrip(lambda h: inbox.put(h) is None,
                                    poll_s=0.05),
            "shipper": KVBlockShipper("prefill0", channel_bytes=channel_bytes,
                                      ship_timeout_s=60.0)}

    def register(tr):
        rd = attach_edge_transport(tr, 0, device=device)
        if rd.device.type == "cuda":
            t0 = time.perf_counter()
            rd.channel.pin_for_cuda()
            edge["pin_s"] = time.perf_counter() - t0
        rd._decode = timed(rd._decode, "land")
        edge["reader"] = rd
        edge["strip"].attach(rd, "prefill0")

    peer = dataclasses.replace(local_endpoint_info(), pid=999999)
    edge["shipper"].connect("decode0", peer, register)
    serialization.serialize_parts = timed(serialization.serialize_parts,
                                          "serialize")
    serialization.write_parts = timed(serialization.write_parts,
                                      "segment_write")
    return edge


def close_edge(edge):
    """Stop the landing thread, unpin and unmap the reader's mapping and
    destroy the segment; returns the reader's and writer's stats.  Raises
    if the segment outlives the edge."""
    from ray_tpu_torch._private import serialization
    from ray_tpu_torch._private.shm import open_shm

    serialization.serialize_parts, serialization.write_parts = \
        edge["unwrap"]
    name = edge["reader"].name
    writer = edge["shipper"].stats().get("decode0", {})
    edge["strip"].stop()
    edge["reader"].channel.detach()
    edge["shipper"].close()
    try:
        open_shm(name=name).close()
    except FileNotFoundError:
        return {"writer": writer, "reader": dict(edge["reader"].stats),
                "strip": edge["strip"].stats()}
    raise AssertionError(f"the hand-off segment {name} was not destroyed")


def disaggregate(pre, dec, prompts, max_tokens, edge):
    """Serve ``prompts`` disaggregated (greedy): prefill-only requests on
    ``pre`` (each request's time to first token stamped from submission),
    then per request ``export_kv``, the ship over ``edge``, its landing and
    ``adopt_prefilled`` by ``dec``, then ``dec`` decodes them all.  Each
    landed tensor must equal its export bit for bit in its first
    ``n_blocks`` (and the adopted pool blocks the landed ones), the tier
    must be the device tier, nothing may re-prefill, every export must be
    adopted and both engines' block accounting must hold.  Returns the
    tokens and one record per request."""
    import torch

    from ray_tpu_torch.experimental.channel.transport import TIER_DEVICE
    from ray_tpu_torch.llm import SamplingParams

    def sync():
        if pre.device.type == "cuda":
            torch.cuda.synchronize(pre.device)

    sp = SamplingParams(temperature=0.0, max_tokens=max_tokens)
    first = {}
    record = pre._record_token

    def stamped(i, req, tok):
        first.setdefault(req.request_id, time.perf_counter() - t_submit)
        record(i, req, tok)

    pre._record_token = stamped
    t_submit = time.perf_counter()
    rids = [pre.submit(p, sp, prefill_only=True) for p in prompts]
    while pre.has_unfinished():
        pre.step()
    del pre._record_token
    rows, dids = [], []
    for rid in rids:
        sync()
        t0 = time.perf_counter()
        export = pre.export_kv(rid)
        sync()
        t1 = time.perf_counter()
        sent = edge["shipper"].ship("decode0", export)
        t2 = time.perf_counter()
        landed = edge["inbox"].get(timeout=60)
        t_got = time.perf_counter()
        did = dec.adopt_prefilled(landed)
        sync()
        t3 = time.perf_counter()
        if did is None:
            raise AssertionError(f"request {rid}: the decode engine could "
                                 f"not adopt its hand-off")
        n = export["n_blocks"]
        blocks = dec._adopt_queue[-1].blocks
        equal = all(
            torch.equal(landed["kv"][k][:, :n], t[:, :n].to(
                landed["kv"][k].device))
            and torch.equal(dec.pool[k][:, blocks], landed["kv"][k][:, :n]
                            .to(dec.pool[k].device))
            for k, t in export["kv"].items())
        if not equal or set(landed["kv"]) != set(export["kv"]) \
                or sent["tier"] != TIER_DEVICE:
            raise AssertionError(f"request {rid}: landed equal to export "
                                 f"{equal}, keys {sorted(landed['kv'])}, "
                                 f"tier {sent['tier']}")
        span = {k: 1e3 * v[-1] for k, v in edge["spans"].items()}
        d2h_s = _wall(lambda: [t.cpu() for t in export["kv"].values()])
        rows.append({"prompt_tokens": len(export["prompt_tokens"]),
                     "n_blocks": n, "shipped_blocks":
                     int(export["kv"]["k"].shape[1]),
                     "tensors": sorted(export["kv"]),
                     "ttft_s": first[rid], "export_ms": 1e3 * (t1 - t0),
                     "ship_ms": 1e3 * (t2 - t1),
                     "serialize_ms": span["serialize"],
                     "segment_write_ms": span["segment_write"],
                     "d2h_alone_ms": 1e3 * d2h_s,
                     "land_ms": span["land"],
                     "adopt_ms": 1e3 * (t3 - t_got),
                     "handoff_ms": 1e3 * (t3 - t0),
                     "bytes": sent["bytes"], "tier": sent["tier"],
                     "landed_on": str(landed["kv"]["k"].device)})
        dids.append(did)
        del export, landed
    outs = {}
    while dec.has_unfinished():
        for o in dec.step():
            outs[o.request_id] = o
    for eng in (pre, dec):
        eng.blocks.assert_integrity()
    tokens = [outs[d].token_ids for d in dids]
    faults = [f"request {d}: error {outs[d].error}, {len(outs[d].token_ids)} "
              f"tokens" for d in dids
              if outs[d].error is not None or len(outs[d].token_ids)
              != max_tokens or not all(0 <= t < pre.cfg.vocab_size
                                       for t in outs[d].token_ids)]
    if dec.timing["prefill_tokens"]:
        faults.append(f"the decode engine prefilled "
                      f"{dec.timing['prefill_tokens']} tokens")
    if pre.handoff_stats["exported"] != dec.handoff_stats["adopted"] \
            or dec.handoff_stats["adopt_failures"]:
        faults.append(f"exported {pre.handoff_stats}, adopted "
                      f"{dec.handoff_stats}")
    if faults:
        raise AssertionError("; ".join(faults))
    return tokens, rows


def edge_faults(stats, ships):
    """What makes a hand-off edge's run fail: another tier than the device
    tier, a degraded frame on either end, a frame that was no device
    frame, or a landing that did not reach the decode engine."""
    from ray_tpu_torch.experimental.channel.transport import TIER_DEVICE

    w, r, strip = stats["writer"], stats["reader"], stats["strip"]
    faults = []
    if w.get("tier") != TIER_DEVICE or r["degraded"] or w.get("degraded"):
        faults.append(f"tier {w.get('tier')}, degraded writer "
                      f"{w.get('degraded')} reader {r['degraded']}")
    if w.get("device_frames") != ships or strip["landed"] != ships \
            or strip["adopt_failed"] or strip["decode_errors"]:
        faults.append(f"{ships} ships: writer {w}, strip {strip}")
    return faults


def check_disagg_handoff(cfg, params, device="cuda"):
    """The disaggregated hand-off over a device-tier edge: prefill-only
    requests on a prefill engine with ``prefill_chunk=32``, each export
    shipped, landed bit-equal and adopted by a decode engine: the same
    greedy tokens as the colocated engine, with no degraded frame."""
    from ray_tpu_torch.llm import LLMEngine
    from ray_tpu_torch.llm.kv_transfer import handoff_channel_bytes

    prompts = [[(7 * k + 3) % cfg.vocab_size for k in range(70)], [5, 9, 2],
               [(11 * k + 1) % cfg.vocab_size for k in range(40)]]
    kw = dict(batch_slots=2, max_len=128, block_size=8, device=device)
    want = _greedy_tokens(LLMEngine(cfg, params, **kw), prompts, 12)
    pre = LLMEngine(cfg, params, prefill_chunk=32, **kw)
    dec = LLMEngine(cfg, params, **kw)
    edge = handoff_edge(handoff_channel_bytes(pre), device)
    try:
        got, rows = disaggregate(pre, dec, prompts, 12, edge)
    finally:
        stats = close_edge(edge)
    faults = edge_faults(stats, len(prompts))
    if got != want:
        faults.append(f"disaggregated {got} != colocated {want}")
    if faults:
        raise AssertionError("disagg: " + "; ".join(faults))
    return {"requests": len(rows), "tier": stats["writer"]["tier"],
            "chunks": pre.prefill_stats["chunks"],
            "n_blocks": [r["n_blocks"] for r in rows]}


SERVING_OPTION_CHECKS = {"spec_engine": check_spec_engine,
                         "chunked_prefill": check_chunked_prefill,
                         "int8_folded": check_int8_folded,
                         "generate_speculative": check_generate_speculative,
                         "disagg_handoff": check_disagg_handoff}


def _launch_counts():
    from ray_tpu_torch.ops.cuda.flash_attention import (flash_attention_bwd,
                                                        flash_attention_fwd)

    return (flash_attention_fwd.launches, flash_attention_bwd.dq_launches,
            flash_attention_bwd.dkv_launches)


def train_vs_cpu(cfg, params, make_trainer, tokens, device, steps,
                 make_reference=None):
    """``steps`` fp32 train steps of ``make_trainer(cfg)`` from ``params``
    on ``device`` and of ``make_reference(cfg)`` (default the same
    function) through the plain versions on the CPU, from the same
    weights and tokens (a token tensor, or a whole batch dict).  Loss to rtol 1e-5 and grad norm to 1e-4 (fp32
    sums in another order).  Params: the difference of the two updates
    has at most 1e-3 of the update's L2 norm, and no element differs by
    more than Adam's bound of one step each way (2 * the sum of the
    learning rates): Adam moves each element by about lr whatever its
    grad, so an element whose grad is about eps (1e-8) can turn on fp32
    summation noise alone.  Returns the errors and the K1/K2/K3 launches
    of the steps on ``device``."""
    import copy

    import torch

    from ray_tpu_torch.models.training import default_optimizer, tree_leaves

    opt = default_optimizer(lr=1e-3, warmup=1, decay_steps=10)
    batch = tokens if isinstance(tokens, dict) else {"tokens": tokens}
    runs = []
    for make, dev in ((make_trainer, device),
                      (make_reference or make_trainer, "cpu")):
        tr = make(cfg, optimizer=opt, device=dev)
        state = tr.init_state(params=copy.deepcopy(params))
        counts = _launch_counts()
        metrics = []
        for _ in range(steps):
            state, m = tr.step(state, batch)
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
        launched = [now - before for now, before in zip(_launch_counts(),
                                                        counts)]
        runs.append((metrics, [full_tensor(t).cpu() for t in
                               tree_leaves(state["params"])], launched))
    (got, got_p, launched), (want, want_p, _) = runs
    loss_err = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(got, want))
    norm_err = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(got, want))
    param_err = max(float((a - b).abs().max()) for a, b in zip(got_p, want_p))
    update_err = math.sqrt(sum(float((a - b).square().sum())
                               for a, b in zip(got_p, want_p))) / math.sqrt(
        sum(float((b - p0).square().sum()) for b, p0 in
            zip(want_p, tree_leaves(params))))
    one_step_each_way = 2 * sum(opt.learning_rate(c) for c in range(steps))
    if not (loss_err <= 1e-5 and norm_err <= 1e-4 and update_err <= 1e-3
            and param_err <= one_step_each_way):
        raise AssertionError(
            f"train steps on {device} vs the plain path on the CPU: loss "
            f"rel {loss_err}, grad norm rel {norm_err}, update rel L2 "
            f"{update_err}, params max |d| {param_err} (bound "
            f"{one_step_each_way})")
    return {"train_losses_grad_norms": got,
            "train_loss_rel_err": loss_err, "train_norm_rel_err": norm_err,
            "train_params_max_abs_err": param_err,
            "train_update_rel_l2_err": update_err,
            "train_k1_k2_k3_launches": launched}


def full_tensor(t):
    """A tensor's global value, detached: a DTensor's gathered whole."""
    t = t.detach()
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def small_train_reference(device="cuda", steps=3):
    """Three fp32 train steps of a small Llama (head_dim 64, s=300, flash
    attention under ``save_attn``) on ``device`` against the plain path
    on the CPU (``train_vs_cpu``).  On the card K1, K2 and K3 must each
    launch once per layer per step."""
    import torch

    from ray_tpu_torch.models.llama import llama_init
    from ray_tpu_torch.models.training import make_llama_trainer

    cfg = small_train_config()
    tokens = torch.randint(0, cfg.vocab_size, (2, 301),
                           generator=torch.Generator().manual_seed(6))
    out = train_vs_cpu(cfg, llama_init(cfg, seed=5, device="cpu"),
                       make_llama_trainer, tokens, device, steps)
    launched = out["train_k1_k2_k3_launches"]
    if device == "cuda" and launched != [steps * cfg.num_layers] * 3:
        raise AssertionError(f"K1/K2/K3 launched {launched} times in "
                             f"{steps} steps of {cfg.num_layers} layers")
    return out


def small_moe_reference(device="cuda", steps=3):
    """A small fp32 MoE (head_dim 64, which K1-K3 take; 4 experts, top-2;
    s=300; flash attention) on ``device`` against the plain path on the
    CPU, from the same weights and tokens: the forward's logits (fp32
    sums in another order: 1e-4, as the Llama forward) and router aux
    (rtol 1e-5), then ``steps`` trainer steps (``train_vs_cpu``).  On the
    card K1 must launch once per layer in the forward and, each layer
    replayed whole under remat, twice per layer per step, K2 and K3 once
    per layer per step."""
    import torch

    from ray_tpu_torch.models.moe import (MoEConfig, make_moe_trainer,
                                          moe_apply, moe_init)

    cfg = MoEConfig.tiny_moe(hidden_size=256, num_heads=4, num_kv_heads=2,
                             max_seq_len=512, dtype=torch.float32,
                             attention_impl="flash")
    params = moe_init(cfg, seed=7, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 301),
                           generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        want, want_aux = moe_apply(params, tokens[:, :-1], cfg)
        before = _launch_counts()[0]
        on_device = {k: ({n: t.to(device) for n, t in v.items()}
                         if isinstance(v, dict) else v.to(device))
                     for k, v in params.items()}
        got, got_aux = moe_apply(on_device, tokens[:, :-1].to(device), cfg)
        fwd_launched = _launch_counts()[0] - before
    fwd_err = float((got.cpu() - want).abs().max())
    aux_err = abs(float(got_aux) - float(want_aux)) / abs(float(want_aux))
    if not (fwd_err <= 1e-4 and aux_err <= 1e-5):
        raise AssertionError(f"MoE forward on {device} vs the plain path on "
                             f"the CPU: logits max |d| {fwd_err} (1e-4), aux "
                             f"rel {aux_err} (1e-5)")
    out = train_vs_cpu(cfg, params, make_moe_trainer, tokens, device, steps)
    L = cfg.num_layers
    launched = out["train_k1_k2_k3_launches"]
    if device == "cuda" and (fwd_launched != L or launched != [
            2 * steps * L, steps * L, steps * L]):
        raise AssertionError(f"MoE: K1 launched {fwd_launched} times in the "
                             f"forward, K1/K2/K3 {launched} times in {steps} "
                             f"steps of {L} layers under full remat")
    return {"forward_vs_cpu_max_abs": fwd_err, "aux_vs_cpu_rel": aux_err,
            "forward_k1_launches": fwd_launched,
            **out}


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
    busy_ms, top = rank_kernels(device_times(
        lambda: llama_apply(params, tokens, cfg)))
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


# ---------------------------------------------------------------------------
# The compiled-graph DAG (dag_forward, dag_pipeline, dag4): Llama stages,
# each in a process actor of its own (ray_tpu_torch.actor)
# ---------------------------------------------------------------------------


def tree_items(tree, prefix=""):
    """``(path, leaf)`` of a params tree in its insertion order, paths
    joined by "/"."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def stage_params(cfg, lo, hi, *, seed=0, params=None, device=None):
    """Stage ``[lo, hi)`` of a Llama's params: layers ``lo..hi-1``, the
    embedding with layer 0 and the final norm and head with the last.
    From ``params`` (a whole tree, each piece copied) or drawn from
    ``seed`` exactly as ``llama_init`` draws the whole tree, leaf by leaf:
    a stacked leaf is drawn whole, its slice kept and the rest dropped at
    once, so the process never holds more than its stage and one whole
    leaf."""
    import torch

    from ray_tpu_torch._device import resolve_device

    if cfg.tie_embeddings:
        raise ValueError("a stage split of tied embeddings needs the table "
                         "on the first and the last stage")
    dev = resolve_device(device)
    first, last = lo == 0, hi == cfg.num_layers
    if params is not None:
        out = {"layers": {k: v[lo:hi].to(dev).clone()
                          for k, v in params["layers"].items()}}
        if first:
            out["embed"] = params["embed"].to(dev).clone()
        if last:
            out["final_norm"] = params["final_norm"].to(dev).clone()
            out["lm_head"] = params["lm_head"].to(dev).clone()
        return out
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    hd = cfg.resolved_head_dim
    h, L = cfg.hidden_size, cfg.num_layers
    q_out, kv_out = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=cfg.param_dtype) * 0.02

    def ones(*shape):
        return torch.ones(shape, device=dev, dtype=cfg.param_dtype)

    out = {}
    embed = normal(cfg.vocab_size, h)
    if first:
        out["embed"] = embed
    del embed
    layers = {}
    for name, shape, drawn in (
            ("attn_norm", (h,), False), ("wq", (h, q_out), True),
            ("wk", (h, kv_out), True), ("wv", (h, kv_out), True),
            ("wo", (q_out, h), True), ("mlp_norm", (h,), False),
            ("w_gate", (h, cfg.mlp_dim), True),
            ("w_up", (h, cfg.mlp_dim), True),
            ("w_down", (cfg.mlp_dim, h), True)):
        if drawn:
            whole = normal(L, *shape)
            layers[name] = whole[lo:hi].clone()
            del whole
        else:
            layers[name] = ones(hi - lo, *shape)
    out["layers"] = layers
    if last:
        out["final_norm"] = ones(h)
    head = normal(h, cfg.vocab_size)
    if last:
        out["lm_head"] = head
    return out


class LlamaStage:
    """Layers ``[lo, hi)`` of a Llama in a stage process: its params
    (``stage_params``) on the process's device, and the stage's pieces of
    ``llama_apply`` in its order (the embedding first, ``_decoder_layer``
    per layer under ``layer_remat`` when autograd records, the head
    last)."""

    def __init__(self, cfg, lo, hi, seed=0, params=None, device=None,
                 train=False):
        import torch

        from ray_tpu_torch._device import resolve_device
        from ray_tpu_torch.actor import process_device

        t0 = time.perf_counter()
        self.cfg, self.lo, self.hi = cfg, lo, hi
        self.first, self.last = lo == 0, hi == cfg.num_layers
        # default: the device of the actor process it lives in
        self.device = resolve_device(device or process_device())
        self.params = stage_params(cfg, lo, hi, seed=seed, params=params,
                                   device=self.device)
        if train:
            for _, t in tree_items(self.params):
                t.requires_grad_(True)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.build_s = time.perf_counter() - t0
        self.pid = os.getpid()

    def _layers(self, x, remat=None):
        import functools

        from ray_tpu_torch.models.llama import (_decoder_layer, rope_tables,
                                                stacked_layers)

        cos, sin = rope_tables(self.cfg, x.shape[1], x.device)
        layer = functools.partial(_decoder_layer, cfg=self.cfg, cos=cos,
                                  sin=sin)
        for _, lp in stacked_layers(self.params):
            x = layer(x, lp) if remat is None else remat(layer, x, lp)
        return x


class ForwardStage(LlamaStage):
    """A serving stage: ``forward(x)`` takes tokens (the first stage) or
    the previous stage's hidden state and returns the next hidden state,
    or on the last stage the last position's fp32 logits and the argmax
    token of every position."""

    def forward(self, x):
        import torch

        from ray_tpu_torch.models.llama import embed_tokens, lm_head

        with torch.no_grad():
            if self.first:
                x = embed_tokens(self.params, x.to(self.device), self.cfg)
            x = self._layers(x)
            if not self.last:
                return x
            logits = lm_head(self.params, self.cfg, x)
            return {"last_logits": logits[:, -1],
                    "tokens": logits.argmax(-1)}


class TrainStage(LlamaStage):
    """A training stage for ``PipelineRunner``: ``forward(mb, x)`` takes a
    microbatch's tokens ``[b, s + 1]`` (the first stage) or the previous
    stage's ``{"h", "tokens"}``, keeps what its backward needs, and passes
    the hidden state and the tokens on; the last stage returns the
    microbatch's loss (``llama_loss``'s next-token mean).
    ``backward(mb, g)`` back-propagates ``g`` (the last stage its loss)
    into the stage's ``.grad``, which accumulate over microbatches, and
    returns the gradient of its input hidden state."""

    def __init__(self, cfg, lo, hi, seed=0, params=None, device=None):
        from ray_tpu_torch.models.llama import layer_remat

        super().__init__(cfg, lo, hi, seed=seed, params=params,
                         device=device, train=True)
        self.remat = layer_remat(cfg)
        self.acts = {}
        self.order = []

    def forward(self, mb, x):
        from ray_tpu_torch.models.llama import (embed_tokens, lm_head,
                                                next_token_nll)

        self.order.append(("F", mb))
        if self.first:
            tokens, inp = x.to(self.device), None
            h = embed_tokens(self.params, tokens[:, :-1], self.cfg)
        else:
            tokens = x["tokens"]
            inp = h = x["h"].detach().requires_grad_(True)
        h = self._layers(h, self.remat)
        if self.last:
            loss = next_token_nll(lm_head(self.params, self.cfg, h),
                                  tokens).mean()
            self.acts[mb] = (inp, loss)
            return float(loss.detach())
        self.acts[mb] = (inp, h)
        return {"h": h.detach(), "tokens": tokens}

    def backward(self, mb, g):
        self.order.append(("B", mb))
        inp, out = self.acts.pop(mb)
        out.backward(g)
        return None if inp is None else inp.grad


def stage_info(stage):
    """``_remote_call`` body: the stage's pid, build seconds, device and
    the bytes of its params."""
    return {"pid": stage.pid, "build_s": stage.build_s,
            "device": str(stage.device),
            "params_gb": sum(t.numel() * t.element_size()
                             for _, t in tree_items(stage.params)) / 1e9}


def stage_launches(stage):
    """``_remote_call`` body: K1-K4 launches counted in this process."""
    return list(_all_launches())


def stage_zero_launches(stage):
    """``_remote_call`` body: zero this process's launch counts (and the
    order and grads of a training stage, for a fresh timed run)."""
    _zero_launches()
    if isinstance(stage, TrainStage):
        stage.order = []
        for _, t in tree_items(stage.params):
            t.grad = None
    return True


def stage_memory(stage):
    """``_remote_call`` body: this process's device memory, allocated now
    and at its peak, in GB."""
    import torch

    if stage.device.type != "cuda":
        return {"allocated_gb": "not measured", "peak_gb": "not measured"}
    return {"allocated_gb": torch.cuda.memory_allocated() / 1e9,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def stage_grad_digests(stage):
    """``_remote_call`` body: ``tensor_digest`` of every grad leaf."""
    return {p: tensor_digest(t.grad) for p, t in tree_items(stage.params)}


def stage_grads(stage, paths=None):
    """``_remote_call`` body: grad leaves on the host (all, or ``paths``)."""
    return {p: t.grad.detach().cpu() for p, t in tree_items(stage.params)
            if paths is None or p in paths}


def stage_order(stage):
    """``_remote_call`` body: the ops the training stage ran, in order."""
    return list(stage.order)


def stage_pipe_transports(stage, key):
    """``_remote_call`` body: the counters of this stage's pipeline
    transports (``PipelineRunner``'s, by edge)."""
    from ray_tpu_torch.dag import pipeline_schedule

    st = pipeline_schedule._PIPE_STATES[key]
    return {tr.edge + f":{side}": {"tier": tr.tier, **tr.stats}
            for side in ("fwd_in", "fwd_out", "bwd_in", "bwd_out")
            for tr in [st.get(side)] if tr is not None}


def stage_slice(tree, lo, hi, L):
    """The paths of a whole tree's leaves that stage ``[lo, hi)`` holds,
    each with its slice of the whole leaf."""
    out = {}
    for p, t in tree_items(tree):
        if p.startswith("layers/"):
            out[p] = t[lo:hi]
        elif (p == "embed" and lo == 0) or (p in ("final_norm", "lm_head")
                                            and hi == L):
            out[p] = t
    return out


def start_stages(cls, specs, device="cuda", timeout=600):
    """One actor of ``cls`` per ``(args, kwargs)`` in ``specs``, started
    together on ``device``; returns the handles, each stage's
    ``stage_info`` and the seconds until every one was built."""
    from ray_tpu_torch import actor

    t0 = time.perf_counter()
    Stage = actor.ActorClass(cls).options(device=device)
    stages = [Stage.remote(*a, **kw) for a, kw in specs]
    try:
        infos = actor.get([s._remote_call.remote(stage_info)
                           for s in stages], timeout=timeout)
    except BaseException:
        for s in stages:
            actor.kill(s)
        raise
    return stages, infos, time.perf_counter() - t0


def dag_channel_waits(before, after):
    """Seconds each exec-loop read edge waited between two ``stats()``."""
    out = {}
    for name, edges in after.get("actor_channels", {}).items():
        for edge, st in edges.items():
            if st["side"] == "read":
                was = before["actor_channels"][name][edge]["read_wait_s"]
                out[edge] = st["read_wait_s"] - was
    for edge, st in after["driver_channels"].items():
        if st["recvs"]:
            out[edge] = (st["read_wait_s"]
                         - before["driver_channels"][edge]["read_wait_s"])
    return out


def dag_degraded(stats):
    """Frames that fell back from the device tier, over every edge."""
    n = sum(st["degraded"] for st in stats["driver_channels"].values())
    for edges in stats.get("actor_channels", {}).values():
        n += sum(st["degraded"] for st in edges.values())
    return n


def phase_dag_forward(cfg, params, fwd, device="cuda", seq=SEQ,
                      execs=DAG_FORWARD_EXECS, inflight=DAG_INFLIGHT):
    """``llama_apply`` as a compiled DAG of two stage processes on one
    card: ``inp -> stage0.forward -> stage1.forward``, each stage built
    from the same seed as ``params`` (half the layers each; the first
    holds the embedding, the last the final norm and head).  One warm-up
    execution, then ``execs`` executions with up to ``inflight`` in
    flight, each on its own tokens; every output (the last position's
    logits and each position's argmax) is held against this process's
    ``llama_apply`` of ``params`` on the same tokens: bit-equal expected,
    a miss within K1's bf16 tolerance (atol = rtol = 2e-2) and reported.
    Every edge must be on the device tier with no degraded frame, and K1
    must launch once per layer of each stage per execution, counted in
    the stage processes."""
    import collections

    import torch

    from ray_tpu_torch import actor
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.models.llama import llama_apply

    t_phase = time.perf_counter()
    L = cfg.num_layers
    half = L // 2
    stages, infos, startup_s = start_stages(
        ForwardStage, [((cfg, 0, half), {"seed": 0}),
                       ((cfg, half, L), {"seed": 0})], device)
    gen = torch.Generator(device=device).manual_seed(5)
    tokens = [torch.randint(0, cfg.vocab_size, (1, seq), generator=gen,
                            device=device) for _ in range(execs + 1)]
    try:
        with InputNode() as inp:
            dag = stages[1].forward.bind(stages[0].forward.bind(inp))
        cdag = dag.experimental_compile(buffer_size_bytes=DAG_BUFFER_BYTES,
                                        submit_timeout=300)
        try:
            cdag.execute(tokens[0]).get(timeout=600)  # warm-up
            actor.get([s._remote_call.remote(stage_zero_launches)
                       for s in stages], timeout=60)
            before = cdag.stats()
            t0 = time.perf_counter()
            pending, outs = collections.deque(), []
            for t in tokens[1:]:
                if len(pending) >= inflight:
                    outs.append(pending.popleft().get(timeout=300))
                pending.append(cdag.execute(t))
            while pending:
                outs.append(pending.popleft().get(timeout=300))
            per_exec_ms = 1e3 * (time.perf_counter() - t0) / execs
            after = cdag.stats()
            launches = actor.get([s._remote_call.remote(stage_launches)
                                  for s in stages], timeout=60)
            t0 = time.perf_counter()
            cdag.execute(tokens[1]).get(timeout=300)
            latency_ms = 1e3 * (time.perf_counter() - t0)
            memory = actor.get([s._remote_call.remote(stage_memory)
                                for s in stages], timeout=60)
        finally:
            cdag.teardown()
    finally:
        for s in stages:
            actor.kill(s)
    with torch.no_grad():
        max_err, exact, within, agree = 0.0, True, True, []
        for t, out in zip(tokens[1:], outs):
            logits = llama_apply(params, t, cfg)
            want_last, want_tok = logits[:, -1], logits.argmax(-1)
            if out["last_logits"].device != want_last.device:
                raise AssertionError(f"dag_forward: logits landed on "
                                     f"{out['last_logits'].device}")
            err = float((out["last_logits"] - want_last).abs().max())
            max_err = max(max_err, err)
            exact = exact and torch.equal(out["last_logits"], want_last) \
                and torch.equal(out["tokens"], want_tok)
            agree.append(float((out["tokens"] == want_tok).float().mean()))
            within = within and torch.allclose(
                out["last_logits"], want_last, atol=2e-2, rtol=2e-2)
    tiers = after["channel_transport"]
    return {"stages": 2, "layers_by_stage": [half, L - half],
            "executions": execs, "inflight": inflight,
            "buffer_size_bytes": DAG_BUFFER_BYTES,
            "weights_by": "each stage drew its half from seed 0",
            "stage_startup_s": startup_s,
            "stage_build_s": [i["build_s"] for i in infos],
            "stage_params_gb": [i["params_gb"] for i in infos],
            "stage_memory": memory,
            "edge_tiers": tiers, "degraded_frames": dag_degraded(after),
            "per_exec_ms": per_exec_ms, "latency_ms_one_in_flight":
            latency_ms, "one_process_forward_ms": fwd["forward_ms"],
            "channel_wait_s_by_edge": dag_channel_waits(before, after),
            "k1_k2_k3_k4_launches_by_stage": launches,
            "k1_per_stage_per_exec": [c[0] / execs for c in launches],
            "bit_equal": exact, "last_logits_max_abs_err": max_err,
            "within_k1_tol": within,
            "token_agreement": agree,
            "phase_s": time.perf_counter() - t_phase}


def check_dag_forward(out):
    """``dag_forward``'s checks, after its line is printed: outputs
    within K1's bf16 tolerance of one process (bit-equal expected), every
    edge on the device tier with no degraded frame, K1 once per layer of
    each stage per execution and K4 never."""
    if not out["within_k1_tol"]:
        raise AssertionError(f"dag_forward: last logits off the one-process "
                             f"forward by {out['last_logits_max_abs_err']}")
    if set(out["edge_tiers"].values()) != {"B-device"} \
            or out["degraded_frames"]:
        raise AssertionError(f"dag_forward: edge tiers {out['edge_tiers']}, "
                             f"{out['degraded_frames']} degraded frames")
    launches = out["k1_k2_k3_k4_launches_by_stage"]
    if out["k1_per_stage_per_exec"] != out["layers_by_stage"] \
            or any(c[3] for c in launches):
        raise AssertionError(f"dag_forward: K1 per stage per execution "
                             f"{out['k1_per_stage_per_exec']}, expected "
                             f"{out['layers_by_stage']}; K1-K4 {launches}")


def pipeline_microbatches(cfg, n, seq, device, seed=6):
    """``n`` microbatches of one row of ``seq + 1`` random tokens."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randint(0, cfg.vocab_size, (1, seq + 1), generator=gen,
                          device=device) for _ in range(n)]


def pipeline_reference(cfg, mbs, device):
    """One process's ``llama_loss`` backward of ``llama_init(cfg, 0)``
    accumulated over ``mbs`` in order: the losses, every grad leaf's
    ``tensor_digest`` by stage slice, the grads on the host, the wall
    seconds and the peak device memory."""
    import torch

    from ray_tpu_torch.models.llama import llama_init, llama_loss

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    params = llama_init(cfg, seed=0, device=device)
    for _, t in tree_items(params):
        t.requires_grad_(True)
    losses = []
    t0 = time.perf_counter()
    for mb in mbs:
        loss = llama_loss(params, {"tokens": mb}, cfg)
        loss.backward()
        losses.append(float(loss.detach()))
    wall_s = time.perf_counter() - t0
    grads = {p: t.grad for p, t in tree_items(params)}
    out = {"losses": losses, "wall_s": wall_s,
           "peak_gb": (torch.cuda.max_memory_allocated() / 1e9 if cuda
                       else "not measured"),
           "host": {p: g.detach().cpu() for p, g in grads.items()}}
    L, half = cfg.num_layers, cfg.num_layers // 2
    out["digests"] = [
        {p: tensor_digest(g) for p, g in stage_slice(
            grads, lo, hi, L).items()} for lo, hi in ((0, half), (half, L))]
    del params, grads
    if cuda:
        torch.cuda.empty_cache()
    return out


def check_dag_pipeline(out):
    """``dag_pipeline``'s checks, after its line is printed: 1F1B order
    per stage, K1 = K2 = K3 = one per layer per microbatch in each stage
    and K4 never, every grad leaf bit-equal or within ``BWD_TOL``, both
    edges on the device tier with no degraded frame, finite losses."""
    if not out["schedule_order_ok"]:
        raise AssertionError(f"dag_pipeline: ops ran in {out['orders']}, "
                             "not in the 1F1B schedule's order")
    for s, (c, want) in enumerate(zip(out["k1_k2_k3_k4_launches_by_stage"],
                                      out["k1_k2_k3_expected_by_stage"])):
        if c[:3] != [want] * 3 or c[3]:
            raise AssertionError(f"dag_pipeline stage {s}: K1-K4 {c}, "
                                 f"expected K1 = K2 = K3 = {want}, K4 = 0")
    misses = out["grad_misses"]
    if any(not m["within_bwd_tol"] for m in misses.values()):
        raise AssertionError(f"dag_pipeline: grads off the one-process "
                             f"accumulation past BWD_TOL: {misses}")
    if out["edge_tiers"] != {"fwd:0->1": "B-device",
                             "bwd:1->0": "B-device"} \
            or out["degraded_frames"]:
        raise AssertionError(f"dag_pipeline: edge tiers {out['edge_tiers']}"
                             f", {out['degraded_frames']} degraded frames")
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"dag_pipeline: losses {out['losses']}")


def grad_miss(got, want):
    """A grad leaf against the reference's: its largest error and whether
    it is within ``BWD_TOL["bfloat16"]`` (elementwise atol of K3's dk,
    the loosest of a layer's, with its rtol, and the relative L2)."""
    import torch

    tol = BWD_TOL["bfloat16"]
    got, want = got.double(), want.double()
    err = float((got - want).abs().max())
    rel_l2 = float(torch.linalg.vector_norm(got - want)
                   / torch.linalg.vector_norm(want).clamp_min(1e-30))
    ok = bool(((got - want).abs() <= tol["atol"][1]
               + tol["rtol"] * want.abs()).all()) and \
        rel_l2 <= tol["rel_l2"]
    return {"max_abs_err": err, "rel_l2": rel_l2, "within_bwd_tol": ok}


def phase_dag_pipeline(cfg, train=None, device="cuda", seq=SEQ,
                       n_micro=DAG_MICROBATCHES):
    """The ``train`` phase's model through ``PipelineRunner(transport=
    "channels")``: two stage processes on one card (half the layers each;
    the first holds the embedding, the last the final norm and head),
    ``n_micro`` microbatches of one row of ``seq + 1`` tokens under 1F1B.
    First one process's ``llama_loss`` backward of the same weights
    accumulated over the same microbatches in the same order
    (``pipeline_reference``), then the card is freed for the stages.  One
    warm-up run, then the grads and counts are zeroed and one run is timed
    and checked: each stage's grad leaves must equal the reference's
    slices bit for bit (by ``tensor_digest``), or a leaf that does not is
    reported with its largest error and must be within ``BWD_TOL``; each
    stage ran its ops in ``build_1f1b_schedule(2, n_micro)`` order; K1, K2
    and K3 launched once per layer per microbatch in each stage process
    and K4 never; both edges are on the device tier, none degraded."""
    import torch

    from ray_tpu_torch import actor
    from ray_tpu_torch.dag.pipeline_schedule import (PipelineRunner,
                                                     build_1f1b_schedule)

    t_phase = time.perf_counter()
    L = cfg.num_layers
    half = L // 2
    mbs = pipeline_microbatches(cfg, n_micro, seq, device)
    ref = pipeline_reference(cfg, mbs, device)
    stages, infos, startup_s = start_stages(
        TrainStage, [((cfg, 0, half), {"seed": 0}),
                     ((cfg, half, L), {"seed": 0})], device)
    try:
        runner = PipelineRunner(stages, transport="channels",
                                buffer_size=DAG_BUFFER_BYTES,
                                op_timeout_s=300.0)
        try:
            runner.run(mbs, timeout=600)  # warm-up
            actor.get([s._remote_call.remote(stage_zero_launches)
                       for s in stages], timeout=60)
            res = runner.run(mbs, timeout=600)
            launches = actor.get([s._remote_call.remote(stage_launches)
                                  for s in stages], timeout=60)
            orders = actor.get([s._remote_call.remote(stage_order)
                                for s in stages], timeout=60)
            digests = actor.get([s._remote_call.remote(stage_grad_digests)
                                 for s in stages], timeout=300)
            memory = actor.get([s._remote_call.remote(stage_memory)
                                for s in stages], timeout=60)
            transports = actor.get(
                [s._remote_call.remote(stage_pipe_transports, runner._key)
                 for s in stages], timeout=60)
            misses = {}
            for s, (got, want) in enumerate(zip(digests, ref["digests"])):
                bad = sorted(p for p in want if got.get(p) != want[p])
                if bad:
                    leaves = stages[s]._remote_call.remote(
                        stage_grads, bad).get(timeout=600)
                    whole = stage_slice(ref["host"], *(
                        (0, half) if s == 0 else (half, L)), L)
                    misses.update({f"stage{s}/{p}": grad_miss(
                        leaves[p], whole[p]) for p in bad})
        finally:
            runner.close()
    finally:
        for s in stages:
            actor.kill(s)
    sched = build_1f1b_schedule(2, n_micro)
    stats = res.stats
    losses = [res.outputs[i] for i in range(n_micro)]
    out = {"stages": 2, "layers_by_stage": [half, L - half],
           "microbatches": n_micro, "batch": 1, "seq": seq,
           "remat_policy": cfg.remat_policy,
           "weights_by": "each stage drew its half from seed 0",
           "stage_startup_s": startup_s,
           "stage_build_s": [i["build_s"] for i in infos],
           "stage_params_gb": [i["params_gb"] for i in infos],
           "stage_memory": memory, "reference_peak_gb": ref["peak_gb"],
           "reference_wall_ms": 1e3 * ref["wall_s"],
           "losses": losses,
           "losses_equal_one_process": losses == ref["losses"],
           "one_process_losses": ref["losses"],
           "grad_leaves": sum(len(d) for d in ref["digests"]),
           "grad_leaves_bit_equal": sum(len(d) for d in ref["digests"])
           - len(misses), "grad_misses": misses,
           "schedule_order_ok": [[tuple(o) for o in order]
                                 for order in orders] == sched,
           "orders": orders,
           "k1_k2_k3_k4_launches_by_stage": launches,
           "k1_k2_k3_expected_by_stage": [half * n_micro,
                                          (L - half) * n_micro],
           "edge_tiers": stats["channel_transport"],
           "degraded_frames": sum(st["degraded"] for edges in transports
                                  for st in edges.values()),
           "wall_ms": 1e3 * stats["wall_s"],
           "bubble_fraction": stats["bubble_fraction"],
           "analytic_bubble": stats["analytic_bubble"],
           "stage_imbalance": stats["stage_imbalance"],
           "per_stage": stats["per_stage"],
           "channel_wait_s_by_tier": stats["channel_wait_s_by_tier"],
           "transports": transports,
           "phase_s": time.perf_counter() - t_phase}
    if train is not None:
        out["four_train_steps_ms"] = 4 * train["step_ms"]
        out["four_train_steps_minus_optimizer_ms"] = 4 * (
            train["step_ms"] - train["optimizer_ms"])
    return out


class DPStage:
    """A data-parallel replica for ``dag4``: a Llama's params
    (``llama_init`` from seed 0, the same on every replica) and its own
    batches (one row of ``seq + 1`` tokens per step from seed
    ``100 + rank``).  ``grad(step)`` is the local gradient flattened into
    one tensor, ``busy_work(step)`` compute independent of it,
    ``apply(g, aux)`` an SGD step with the allreduced gradient over the
    world (at step 0 rank 0 also sums every replica's local gradient
    itself, the one-process reference)."""

    def __init__(self, cfg, rank, world, steps, seq=SEQ, lr=1e-3,
                 device=None):
        import torch

        from ray_tpu_torch._device import resolve_device
        from ray_tpu_torch.actor import process_device
        from ray_tpu_torch.models.llama import llama_init

        self.cfg, self.rank, self.world, self.lr = cfg, rank, world, lr
        self.device = resolve_device(device or process_device())
        self.params = llama_init(cfg, seed=0, device=self.device)
        for _, t in tree_items(self.params):
            t.requires_grad_(True)
        self.batches = [pipeline_microbatches(cfg, steps, seq, self.device,
                                              seed=100 + r)
                        for r in range(world)]
        self.sum_check = None
        self.loss = None
        self.pid = os.getpid()
        self.build_s = 0.0
        w = torch.Generator(device=self.device).manual_seed(rank)
        self.busy = torch.randn(4096, 4096, generator=w, device=self.device)

    def _local_grad(self, tokens):
        import torch

        from ray_tpu_torch.models.llama import llama_loss

        for _, t in tree_items(self.params):
            t.grad = None
        loss = llama_loss(self.params, {"tokens": tokens}, self.cfg)
        loss.backward()
        return float(loss.detach()), torch.cat([t.grad.reshape(-1) for _, t in
                                       tree_items(self.params)])

    def grad(self, step):
        self.step = step
        self.loss, g = self._local_grad(self.batches[self.rank][step])
        return g

    def busy_work(self, step):
        import torch

        y = self.busy
        for _ in range(8):
            y = torch.tanh(y @ self.busy)
        return float(y.float().mean())

    def apply(self, g, aux):
        import torch

        if self.step == 0 and self.rank == 0:
            # the one-process sum of every replica's local gradient at the
            # common starting point, in rank order, against the
            # allreduced one: fp32 sums of `world` terms in another order
            # differ by at most (world - 1) * 2^-23 * sum |g_r| each way
            total = absum = None
            for r in range(self.world):
                _, gr = self._local_grad(self.batches[r][0])
                total = gr.clone() if total is None else total + gr
                absum = gr.abs() if absum is None else absum + gr.abs()
            bound = 2 * (self.world - 1) * 2.0 ** -23 * absum
            diff = (g - total).abs()
            self.sum_check = {"max_abs_err": float(diff.max()),
                              "bit_equal": bool(torch.equal(g, total)),
                              "within_bound": bool((diff <= bound).all())}
        with torch.no_grad():
            off = 0
            for _, t in tree_items(self.params):
                n = t.numel()
                t -= self.lr * g[off:off + n].view_as(t) / self.world
                off += n
        flat = torch.cat([t.detach().reshape(-1) for _, t in
                          tree_items(self.params)])
        return {"rank": self.rank, "loss": self.loss, "aux": aux,
                "params_digest": tensor_digest(flat),
                "grad_digest": tensor_digest(g)}


def dp_sum_check(stage):
    """``_remote_call`` body: ``DPStage``'s step-0 reference check."""
    return stage.sum_check


def phase_dag4(cfg=None, world=MESH4_RANKS, steps=DAG4_STEPS, seq=SEQ,
               device="cuda", backend="nccl"):
    """A data-parallel step of a ``DAG4_LAYERS``-layer Llama-2-7B-width
    model (fp32 params, bf16 compute) as one compiled DAG over ``world``
    actors, one card each: ``grad`` -> ``allreduce.bind(...,
    backend="nccl")`` overlapped with ``busy_work`` -> ``apply`` (SGD).
    After ``steps`` steps the replicas' params must be bit-identical, and
    at step 0 the allreduced gradient must match the four local gradients
    summed in one process (rank 0) within the fp32 bound of reordered
    sums.  Every edge is on the device tier."""
    import torch

    from ray_tpu_torch import actor
    from ray_tpu_torch.dag import InputNode, MultiOutputNode, allreduce

    t_phase = time.perf_counter()
    if cfg is None:
        cfg = dataclasses.replace(train_config(), num_layers=DAG4_LAYERS)
    devices = ([f"cuda:{r}" for r in range(world)] if device == "cuda"
               else ["cpu"] * world)
    t0 = time.perf_counter()
    workers = [actor.ActorClass(DPStage).options(device=d).remote(
        cfg, r, world, steps, seq) for r, d in enumerate(devices)]
    try:
        actor.get([w._remote_call.remote(stage_info) for w in workers],
                  timeout=600)
        startup_s = time.perf_counter() - t0
        with InputNode() as inp:
            grads = [w.grad.bind(inp) for w in workers]
            reduced = allreduce.bind(grads, backend=backend)
            aux = [w.busy_work.bind(inp) for w in workers]
            dag = MultiOutputNode([w.apply.bind(r, a) for w, r, a in
                                   zip(workers, reduced, aux)])
        cdag = dag.experimental_compile(submit_timeout=300)
        try:
            outs, step_ms = [], []
            for step in range(steps):
                if step == 1:
                    # count the later steps: rank 0's first also runs the
                    # one-process reference
                    actor.get([w._remote_call.remote(stage_zero_launches)
                               for w in workers], timeout=60)
                t0 = time.perf_counter()
                outs.append(cdag.execute(step).get(timeout=600))
                step_ms.append(1e3 * (time.perf_counter() - t0))
            stats = cdag.stats()
            launches = actor.get([w._remote_call.remote(stage_launches)
                                  for w in workers], timeout=60)
        finally:
            cdag.teardown()
        check = workers[0]._remote_call.remote(dp_sum_check).get(timeout=60)
    finally:
        for w in workers:
            actor.kill(w)
    digests = [[o["params_digest"] for o in out] for out in outs]
    if any(len(set(d)) != 1 for d in digests):
        raise AssertionError(f"dag4: replicas differ after a step: "
                             f"{digests}")
    if not check["within_bound"]:
        raise AssertionError(f"dag4: allreduced gradient off the "
                             f"one-process sum: {check}")
    tiers = set(stats["channel_transport"].values()) - {"A-fused"}
    if device == "cuda" and tiers != {"B-device"}:
        raise AssertionError(f"dag4: edge tiers "
                             f"{stats['channel_transport']}")
    per_step = [[c / (steps - 1) for c in counts] for counts in launches]
    want = [cfg.num_layers] * 3 + [0]
    if device == "cuda" and any(c != want for c in per_step):
        raise AssertionError(f"dag4: K1-K4 per step by rank {per_step}, "
                             f"expected {want}")
    return {"ran": True, "ranks": world, "layers": cfg.num_layers,
            "backend": backend, "steps": steps, "step_ms": step_ms,
            "grad_elements": cfg.num_params(),
            "losses_by_step": [[o["loss"] for o in out] for out in outs],
            "replicas_bit_identical": True, "sum_check": check,
            "k1_k2_k3_k4_per_step_by_rank": per_step,
            "edge_tiers": stats["channel_transport"],
            "stage_startup_s": startup_s,
            "phase_s": time.perf_counter() - t_phase}


def serve_prompts(vocab_size, seed=0):
    """Five prompts of 190-214 tokens; the first two share 64 tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shared = rng.integers(3, vocab_size, size=64).tolist()
    return [shared + rng.integers(3, vocab_size, size=n).tolist()
            for n in (136, 150)] + \
        [rng.integers(3, vocab_size, size=n).tolist()
         for n in (200, 214, 190)]


def _all_launches():
    """K1, K2, K3 and K4 launches so far (each wrapper's count)."""
    from ray_tpu_torch.ops.cuda.remote_copy import remote_copy

    return _launch_counts() + (remote_copy.launches,)


def _zero_launches():
    from ray_tpu_torch.ops.cuda.flash_attention import (flash_attention_bwd,
                                                        flash_attention_fwd)
    from ray_tpu_torch.ops.cuda.remote_copy import remote_copy

    flash_attention_fwd.launches = 0
    flash_attention_bwd.dq_launches = flash_attention_bwd.dkv_launches = 0
    remote_copy.launches = 0


class FirstLogits:
    """Keeps, while in use, the logits of an engine's first admissions
    (``kept["admission"]``: the first call of the engine's own name for
    the batch sampler, one row per slot admitted, on a fresh engine the
    first requests in order) and of its first decode step
    (``kept["decode"]``: the first call of the paged ops' sampler, one
    row per slot)."""

    def __enter__(self):
        from ray_tpu_torch.llm import engine
        from ray_tpu_torch.models import paged_generation

        self.kept, self.plain = {}, []
        for key, module in (("admission", engine),
                            ("decode", paged_generation)):
            plain = module.sample_token_batch
            self.plain.append((module, plain))

            def keep(logits, *a, key=key, plain=plain, **kw):
                if key not in self.kept:
                    self.kept[key] = logits.detach().float().cpu()
                return plain(logits, *a, **kw)

            module.sample_token_batch = keep
        return self

    def __exit__(self, *exc):
        for module, plain in self.plain:
            module.sample_token_batch = plain


def serve_run(eng, cfg, prompts, start=None):
    """The ``serve`` workload through ``eng``: the prompts greedily (32
    new tokens each) with the launches of K1-K4 counted from zero and the
    logits of the first admissions and of the first decode step kept,
    then one decode window profiled
    (``profile_decode_window``; ``start`` runs first inside its profiler
    window).  Fails unless every request gets its 32 tokens in the
    vocabulary and a prefix hit happened."""
    from ray_tpu_torch.llm import SamplingParams

    _zero_launches()
    with FirstLogits() as first:
        t0 = time.perf_counter()
        outs = eng.generate(prompts, SamplingParams(
            temperature=0.0, max_tokens=SERVE_NEW_TOKENS))
        wall_s = time.perf_counter() - t0
    launches = _all_launches()
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
            "k1_launches": launches[0],
            "k1_k2_k3_k4_launches": list(launches),
            "prefix_cache": stats["prefix_cache"],
            "first_tokens": [o.token_ids[:4] for o in outs],
            "token_ids": [o.token_ids for o in outs],
            "first_token_logits": first.kept["admission"],
            "first_decode_logits": first.kept["decode"],
            "decode_profile": profile_decode_window(eng, cfg.vocab_size,
                                                    start=start)}


def phase_serve(cfg, params, device="cuda", max_len=SERVE_MAX_LEN):
    from ray_tpu_torch.llm import LLMEngine

    eng = LLMEngine(cfg, params, batch_slots=SERVE_SLOTS, max_len=max_len,
                    block_size=SERVE_BLOCK, seed=0, device=device)
    return serve_run(eng, cfg, serve_prompts(cfg.vocab_size))


def tree_bytes(tree) -> int:
    """Bytes of a nested dict of tensors (a pool, a rank's local
    shards)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def phase_serve_mesh(cfg, params, serve, device="cuda",
                     max_len=SERVE_MAX_LEN):
    """The ``serve`` phase's engine and requests through a world-1 NCCL
    mesh (``tp=1``: the weights and pool DTensors, every placement
    ``Replicate``, the steps on their local tensors).  Fails unless
    every token equals the ``serve`` phase's; prints decode tokens/s,
    the profiled decode window (busy ms as the union over streams, idle
    share) and peak memory beside ``serve``'s."""
    import torch

    from ray_tpu_torch.llm import LLMEngine
    from ray_tpu_torch.parallel import MeshConfig, create_mesh

    mesh = create_mesh(MeshConfig(dp=1, tp=1), device=device)
    torch.cuda.reset_peak_memory_stats()
    eng = LLMEngine(cfg, params, batch_slots=SERVE_SLOTS, max_len=max_len,
                    block_size=SERVE_BLOCK, seed=0, device=device, mesh=mesh)
    placed = sorted({type(t).__name__ for t in
                     [eng.params["embed"], *eng.params["layers"].values(),
                      *eng.pool.values()]})
    run = serve_run(eng, cfg, serve_prompts(cfg.vocab_size))
    run["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if placed != ["DTensor"]:
        raise AssertionError(f"serve_mesh: weights and pool are {placed}")
    same = run["token_ids"] == serve["token_ids"]
    if not same:
        raise AssertionError(
            f"serve_mesh: tokens differ from serve's: "
            f"{[t[:8] for t in run['token_ids']]} against "
            f"{[t[:8] for t in serve['token_ids']]}")
    keys = ("decode_tokens_per_s", "prefill_ms", "wall_s")
    return {"mesh": str(mesh), "placed_as": placed,
            "tokens_equal_serve": same,
            "serve_phase": {**{k: serve[k] for k in keys},
                            "decode_profile": serve["decode_profile"]},
            **run}


def run_timed(eng, prompts, max_tokens):
    """Greedy ``prompts`` through ``eng`` step by step.  Returns the
    outputs, each request's time to first token (host seconds from
    submission to its first token's fetch, stamped by wrapping
    ``_record_token``) and the wall time."""
    from ray_tpu_torch.llm import SamplingParams

    sp = SamplingParams(temperature=0.0, max_tokens=max_tokens)
    ids = [eng.submit(p, sp) for p in prompts]
    first = {}
    record = eng._record_token

    def stamped(i, req, tok):
        first.setdefault(req.request_id, time.perf_counter() - t0)
        record(i, req, tok)

    eng._record_token = stamped
    t0 = time.perf_counter()
    outs = {}
    while eng.has_unfinished():
        for o in eng.step():
            outs[o.request_id] = o
    wall_s = time.perf_counter() - t0
    del eng._record_token
    eng.blocks.assert_integrity()
    for rid in ids:
        o = outs[rid]
        if o.error is not None or not o.token_ids or not all(
                0 <= t < eng.cfg.vocab_size for t in o.token_ids):
            raise AssertionError(f"request {rid}: error {o.error}, tokens "
                                 f"{o.token_ids[:8]}")
    return [outs[i].token_ids for i in ids], [first[i] for i in ids], wall_s


def agreement(cfg, params, prompts, got, want):
    """How far a run's greedy tokens (``got``) follow a reference run's
    (``want``) on the same prompts: the share of positions equal, and per
    request the first differing position with the top-two logit margin
    there, from a full ``llama_apply`` of the reference's context (a
    small margin: an argmax that bf16 rounding can flip)."""
    import torch

    from ray_tpu_torch.models.llama import llama_apply

    same = total = 0
    first = []
    for p, a, b in zip(prompts, got, want):
        same += sum(x == y for x, y in zip(a, b))
        total += max(len(a), len(b))
        d = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 None if len(a) == len(b) else min(len(a), len(b)))
        if d is None:
            first.append(None)
            continue
        ctx = torch.tensor([p + b[:d]], device=params["embed"].device)
        top = llama_apply(params, ctx, cfg)[0, -1].topk(2).values
        first.append({"position": d, "top2_margin": float(top[0] - top[1])})
    return {"share_equal": same / total, "first_diff": first}


def repeated_bigrams(tokens) -> int:
    """How many bigrams of ``tokens`` occurred earlier in it: the places a
    prompt-lookup drafter (``spec_ngram=2``) could find a draft."""
    seen, n = set(), 0
    for bigram in zip(tokens, tokens[1:]):
        n += bigram in seen
        seen.add(bigram)
    return n


def greedy_fixed_points(cfg, params, device="cuda", chunk=4000):
    """The model's loops of period one: every token t whose greedy
    successor of the one-token context ``[t]`` is t itself, with its
    top-two logit margin, largest margin first (one forward of every
    vocabulary token alone, ``chunk`` at a time).  Over a context of t
    alone each position's attention averages copies of one value, so
    greedy decoding from ``[t]`` goes on repeating t as long as bf16
    rounding keeps the margin."""
    import torch

    from ray_tpu_torch.models.llama import llama_apply

    found = []
    for start in range(0, cfg.vocab_size, chunk):
        toks = torch.arange(start, min(cfg.vocab_size, start + chunk),
                            device=device)
        top = llama_apply(params, toks[:, None], cfg)[:, 0].topk(2, dim=-1)
        for j in (top.indices[:, 0] == toks).nonzero()[:, 0].tolist():
            found.append((start + j, float(top.values[j, 0]
                                           - top.values[j, 1])))
    return sorted(found, key=lambda f: -f[1])


def decode_rate(eng):
    t = eng.stats()["timing"]
    return t["decode_tokens"] / t["decode_s"] if t["decode_s"] else None


def phase_serve_options(cfg, params, device="cuda", max_len=SERVE_MAX_LEN):
    """The engine's serving options on the 7B bf16 weights, each beside
    the plain engine on the same prompts (greedy):

    (a) speculative decoding: a plain run of ``LOOP_WARM_TOKENS`` from
        the model's strongest greedy fixed point (its own loop) is the
        loop prompt, served alone and then with the five serve prompts
        at ``spec_tokens=SPEC_TOKENS``; beside it, how often the plain
        run from the first serve prompt (in the same warm run) repeats a
        bigram;
    (b) chunked prefill: the five serve prompts and one of
        ``LONG_PROMPT`` tokens at ``prefill_chunk=PREFILL_CHUNK``;
    (c) the int8 KV pool: the five serve prompts, then one decode step's
        device time through each int8 path and the bf16 pool at the table
        capacities ``CROSSOVER_LENS``.
    """
    import numpy as np
    import torch

    from ray_tpu_torch.llm import LLMEngine

    kw = dict(max_len=max_len, block_size=SERVE_BLOCK, seed=0,
              device=device)
    prompts = serve_prompts(cfg.vocab_size)
    part_s = {}
    t0 = time.perf_counter()

    # (a) speculative decoding.  From a serve prompt the random-weight
    # model's greedy trajectory need not loop at all (``serve_prompt``
    # reports its repeated bigrams); its own loop is found directly: a
    # greedy fixed point, whose plain trajectory is the loop prompt
    fixed = greedy_fixed_points(cfg, params, device)
    if not fixed:
        raise AssertionError("the model has no greedy fixed point: no "
                             "loop of its own to speculate on")
    t = fixed[0][0]
    warm = LLMEngine(cfg, params, batch_slots=2, **kw)
    walk, tail = run_timed(warm, [prompts[0], [t]], LOOP_WARM_TOKENS)[0]
    loop = [t] + tail
    del warm
    spec = {"serve_prompt": {"greedy_tokens": len(walk),
                             "repeated_bigrams": repeated_bigrams(walk),
                             "distinct_tokens": len(set(walk))},
            "fixed_points": [{"token": f, "top2_margin": m}
                             for f, m in fixed],
            "loop_prompt_tokens": len(loop),
            "loop_prompt_share_of_fixed_point": loop.count(t) / len(loop)}
    for name, batch, slots, n in (
            ("loop", [loop], 1, LOOP_NEW_TOKENS),
            ("mixed", [loop] + prompts, SERVE_SLOTS, SERVE_NEW_TOKENS)):
        plain = LLMEngine(cfg, params, batch_slots=slots, **kw)
        want = run_timed(plain, batch, n)[0]
        eng = LLMEngine(cfg, params, batch_slots=slots,
                        spec_tokens=SPEC_TOKENS, **kw)
        got, _, wall_s = run_timed(eng, batch, n)
        st = dict(eng.spec_stats)
        spec[name] = {
            "requests": len(batch), "slots": slots, "new_tokens": n,
            "wall_s": wall_s,
            "spec_stats": st,
            "accepted_per_verify": (st["accepted"] / st["verify_steps"]
                                    if st["verify_steps"] else None),
            "acceptance": (st["accepted"] / st["proposed"]
                           if st["proposed"] else None),
            "decode_tokens_per_s": decode_rate(eng),
            "plain_decode_tokens_per_s": decode_rate(plain),
            "arm_tps": {str(k): v for k, v in eng._arm_tps.items()},
            "agreement_with_plain": agreement(cfg, params, batch, got,
                                              want)}
        if name == "loop" and not (st["proposed"] > 0
                                   and st["accepted"] > 0):
            raise AssertionError(f"no draft accepted on the loop prompt: "
                                 f"{st}")
        del plain, eng

    part_s["speculative"] = time.perf_counter() - t0

    # (b) chunked prefill
    t0 = time.perf_counter()
    rng = np.random.default_rng(5)
    batch = prompts + [rng.integers(3, cfg.vocab_size,
                                    size=LONG_PROMPT).tolist()]
    plain = LLMEngine(cfg, params, batch_slots=SERVE_SLOTS, **kw)
    want, ttft_plain, _ = run_timed(plain, batch, SERVE_NEW_TOKENS)
    eng = LLMEngine(cfg, params, batch_slots=SERVE_SLOTS,
                    prefill_chunk=PREFILL_CHUNK, **kw)
    chunk_ms = []
    admit_chunk = eng._admit_chunk

    def timed_chunk(*a, **k):
        torch.cuda.synchronize()
        t0, before = time.perf_counter(), eng.prefill_stats["chunks"]
        res = admit_chunk(*a, **k)
        torch.cuda.synchronize()
        if eng.prefill_stats["chunks"] > before:
            chunk_ms.append(1e3 * (time.perf_counter() - t0))
        return res

    eng._admit_chunk = timed_chunk
    got, ttft, _ = run_timed(eng, batch, SERVE_NEW_TOKENS)
    chunks = eng.prefill_stats["chunks"]
    if chunks < 4:
        raise AssertionError(f"{chunks} chunks prefilled, expected >= 4")
    chunked = {"prompt_tokens": [len(p) for p in batch],
               "prefill_chunk": PREFILL_CHUNK, "chunks": chunks,
               "chunk_ms": chunk_ms,
               "short_ttft_s": ttft[:-1], "short_ttft_s_unchunked":
               ttft_plain[:-1], "long_ttft_s": ttft[-1],
               "long_ttft_s_unchunked": ttft_plain[-1],
               "decode_tokens_per_s": decode_rate(eng),
               "plain_decode_tokens_per_s": decode_rate(plain),
               "agreement_with_unchunked": agreement(cfg, params, batch,
                                                     got, want)}
    del plain, eng

    part_s["chunked_prefill"] = time.perf_counter() - t0

    # (c) the int8 KV pool
    t0 = time.perf_counter()
    plain = LLMEngine(cfg, params, batch_slots=SERVE_SLOTS, **kw)
    want = run_timed(plain, prompts, SERVE_NEW_TOKENS)[0]
    eng = LLMEngine(cfg, params, batch_slots=SERVE_SLOTS,
                    kv_cache_dtype="int8", **kw)
    got = run_timed(eng, prompts, SERVE_NEW_TOKENS)[0]
    ratio = tree_bytes(eng.pool) / tree_bytes(plain.pool)
    if not ratio <= 0.52:
        raise AssertionError(f"int8 pool is {ratio:.4f} of the bf16 pool")
    int8 = {"pool_bytes": tree_bytes(eng.pool),
            "bf16_pool_bytes": tree_bytes(plain.pool),
            "pool_ratio": ratio,
            "decode_tokens_per_s": decode_rate(eng),
            "bf16_decode_tokens_per_s": decode_rate(plain),
            "first_token_equal": [a[:1] == b[:1] for a, b in zip(got, want)],
            "agreement_with_bf16_pool": agreement(cfg, params, prompts, got,
                                                  want)}
    del plain, eng
    part_s["int8"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    int8["decode_step_device_ms"] = int8_crossover(cfg, params, device)
    part_s["int8_crossover"] = time.perf_counter() - t0
    return {"speculative": spec, "chunked_prefill": chunked, "int8": int8,
            "part_s": part_s}


def phase_disagg(cfg, params, colocated, device="cuda",
                 max_len=SERVE_MAX_LEN):
    """The disaggregated hand-off on the 7B bf16 weights: a prefill engine
    (``prefill_chunk=DISAGG_CHUNK``) and a decode engine, sharing the
    weights, joined by one device-tier edge sized by
    ``handoff_channel_bytes``; the five serve prompts (greedy,
    ``SERVE_NEW_TOKENS`` each), then one request between two int8-pool
    engines over the same edge (values and scales shipped).  Reports each
    request's time to first token on the prefill side, export, ship, land
    and adopt times and bytes, the decode engine's tokens/s (and, in
    turns, with and without an idle landing thread polling), and the
    agreement of the tokens with the colocated ``serve`` phase's
    (``colocated``: bf16 is not token-exact between batch shapes)."""
    import torch

    from ray_tpu_torch.llm import LLMEngine
    from ray_tpu_torch.llm.kv_transfer import handoff_channel_bytes
    from ray_tpu_torch.ops.cuda.flash_attention import flash_attention_fwd

    kw = dict(batch_slots=SERVE_SLOTS, max_len=max_len,
              block_size=SERVE_BLOCK, seed=0, device=device)
    prompts = serve_prompts(cfg.vocab_size)
    flash_attention_fwd.launches = 0
    pre = LLMEngine(cfg, params, prefill_chunk=DISAGG_CHUNK, **kw)
    dec = LLMEngine(cfg, params, **kw)
    segment = handoff_channel_bytes(pre)
    edge = handoff_edge(segment, device)
    try:
        t0 = time.perf_counter()
        got, rows = disaggregate(pre, dec, prompts, SERVE_NEW_TOKENS, edge)
        wall_s = time.perf_counter() - t0
        pre8 = LLMEngine(cfg, params, prefill_chunk=DISAGG_CHUNK,
                         kv_cache_dtype="int8", **kw)
        dec8 = LLMEngine(cfg, params, kv_cache_dtype="int8", **kw)
        got8, rows8 = disaggregate(pre8, dec8, prompts[:1],
                                   SERVE_NEW_TOKENS, edge)
    finally:
        stats = close_edge(edge)
    t = dict(dec.timing)
    poll = landing_poll_cost(dec, prompts[:SERVE_SLOTS], device)
    launches = flash_attention_fwd.launches
    faults = edge_faults(stats, len(prompts) + 1)
    if rows8[0]["tensors"] != ["k", "k_scale", "v", "v_scale"]:
        faults.append(f"the int8 hand-off shipped {rows8[0]['tensors']}")
    if faults:
        raise AssertionError("disagg: " + "; ".join(faults))
    moved = sum(r["bytes"] for r in rows)
    handoff_s = sum(r["handoff_ms"] for r in rows) / 1e3
    return {"requests": len(rows), "prompt_tokens": [len(p) for p in prompts],
            "prefill_chunk": DISAGG_CHUNK, "segment_bytes": segment,
            "pin_ms": 1e3 * edge["pin_s"],
            "tier": stats["writer"]["tier"], "handoffs": rows,
            "handoff_gb_per_s": moved / handoff_s / 1e9,
            "prefill_chunks": pre.prefill_stats["chunks"],
            "prefill_tokens_per_s": pre.timing["prefill_tokens"]
            / pre.timing["prefill_s"],
            "decode_tokens": t["decode_tokens"],
            "decode_tokens_per_s": t["decode_tokens"] / t["decode_s"],
            "decode_prefill_tokens": t["prefill_tokens"],
            "decode_tokens_per_s_by_landing_thread": poll,
            "exported": pre.handoff_stats["exported"]
            + pre8.handoff_stats["exported"],
            "adopted": dec.handoff_stats["adopted"]
            + dec8.handoff_stats["adopted"],
            "wall_s": wall_s, "k1_launches": launches,
            "agreement_with_colocated": agreement(cfg, params, prompts, got,
                                                  colocated),
            "int8": {**rows8[0], "first_tokens": got8[0][:4],
                     "agreement_with_colocated": agreement(
                         cfg, params, prompts[:1], got8, colocated[:1])},
            "writer_stats": stats["writer"], "reader_stats": stats["reader"],
            "strip_stats": stats["strip"]}


def landing_poll_cost(eng, prompts, device="cuda"):
    """Decode tokens/s of ``eng`` on ``prompts`` (greedy, ``POLL_TOKENS``
    new) without and with an idle ``KVLandingStrip`` polling an empty edge
    in this process, in turns (none, polling, polling, none): a decode
    engine's landing thread keeps polling while the engine decodes, and
    its bounded polls take the interpreter lock from a host-bound decode
    loop."""
    from ray_tpu_torch.experimental.channel.transport import (
        TIER_DEVICE, attach_edge_transport, make_edge_transport)
    from ray_tpu_torch.llm import KVLandingStrip

    rates = {"none": [], "polling": []}
    for mode in ("none", "polling", "polling", "none"):
        before = dict(eng.timing)
        tr = make_edge_transport(tier=TIER_DEVICE, buffer_size=1 << 16)
        rd = attach_edge_transport(tr, 0, device=device)
        strip = KVLandingStrip(lambda h: True, poll_s=0.05)
        try:
            if mode == "polling":
                strip.attach(rd)
            run_timed(eng, prompts, POLL_TOKENS)
        finally:
            strip.stop()
            rd.channel.detach()
            tr.destroy()
        rates[mode].append(
            (eng.timing["decode_tokens"] - before["decode_tokens"])
            / (eng.timing["decode_s"] - before["decode_s"]))
    return rates


def int8_crossover(cfg, params, device="cuda"):
    """Device time (torch.profiler, all kernels) of one ``SERVE_SLOTS``-slot
    ``paged_decode_step`` with full block tables, at each capacity of
    ``CROSSOVER_LENS``: the int8 pool through eager dequantization and
    through the scale-folded attend (``INT8_FOLD_MIN_CONTEXT`` moved to
    force each), and the bf16 pool."""
    import torch

    from ray_tpu_torch.models import paged_generation as pg

    out = {}
    saved = pg.INT8_FOLD_MIN_CONTEXT
    try:
        for ml in CROSSOVER_LENS:
            mb = ml // SERVE_BLOCK
            tables = torch.arange(1, SERVE_SLOTS * mb + 1, dtype=torch.int32,
                                  device=device).reshape(SERVE_SLOTS, mb)
            tok = torch.full((SERVE_SLOTS,), 7, dtype=torch.int32,
                             device=device)
            cur = torch.full((SERVE_SLOTS,), ml - 1, dtype=torch.int32,
                             device=device)
            row = {}
            for path, kv, threshold in (("int8_eager", "int8", 1 << 30),
                                        ("int8_folded", "int8", 0),
                                        ("bf16", None, saved)):
                pg.INT8_FOLD_MIN_CONTEXT = threshold
                pool = pg.init_kv_pool(cfg, SERVE_SLOTS * mb + 1,
                                       SERVE_BLOCK, kv_dtype=kv,
                                       device=device)
                busy, _ = rank_kernels(device_times(
                    lambda: pg.paged_decode_step(params, tok, cur, tables,
                                                 pool, cfg), iters=2))
                row[path] = busy
                del pool
            out[str(ml)] = row
    finally:
        pg.INT8_FOLD_MIN_CONTEXT = saved
    return out


def device_events(fn, iters: int = 1, pad_s=PROFILE_PAD_S):
    """The device kernels (``FunctionEvent``) of ``iters`` calls of ``fn``
    under ``torch.profiler``.  The profiler drops every kernel whose
    start or end, moved onto the host's clock, falls outside the host's
    window from start to stop (its log counts them "Out-of-range"), and
    that move is off by more than a short kernel's length now and then
    (``profiler_window_losses``).  So the window opens ``pad_s`` before
    the first call and closes ``pad_s`` after the card has finished."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def profiler_window_losses(windows, pad_s, launches=5):
    """How many of ``windows`` profiler windows (``device_events`` with
    ``pad_s``), each around ``launches`` launches of one short kernel (a
    64 MiB multiply), recorded fewer kernels than were launched."""
    import torch

    x = torch.ones(1 << 24, device="cuda")
    x.mul_(2)
    lost = 0
    for _ in range(windows):
        got = device_events(lambda: x.mul_(1.0), launches, pad_s=pad_s)
        lost += len(got) != launches
    return lost


def device_times(fn, iters: int = 1):
    """Device time per call of ``fn`` by kernel name, over ``iters`` calls
    (``device_events``, after one warm-up call when ``iters > 1``); empty
    when the profiler records no device activity.  Only the CUDA activity
    is traced: the host's ops would add nothing read here and most of the
    profiler's own time."""
    import torch

    if not torch.cuda.is_available():  # a rehearsal on the CPU
        return {}
    if iters > 1:
        fn()
    return by_kernel_name(device_events(fn, iters), iters)


def by_kernel_name(events, iters: int = 1):
    """Device ms per call by kernel name of ``events``, over ``iters``
    calls."""
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us() / 1e3 / iters
    return by_name


def union_ms(events):
    """The ms in which at least one of ``events`` ran, on any stream: the
    length of the union of their intervals, so kernels that run at once
    on two streams count once."""
    total, end = 0.0, None
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in events):
        if end is None or start > end:
            total, end = total + stop - start, stop
        elif stop > end:
            total, end = total + stop - end, stop
    return total / 1e3


def device_profile(fn, start=None, copies=False, counts=False):
    """One call of ``fn`` under ``device_events``: device ms by kernel
    name, and its busy time split by stream use: ``device_busy_ms`` (the
    union of every kernel's interval), ``nccl_ms`` (of NCCL's kernels),
    ``compute_ms`` (of the others), ``overlap_ms`` (both at once), and
    ``call_ms``, the call's own wall from its start to the card's end.
    ``start`` runs first inside the window, outside ``call_ms``: for
    ranks of a group a host barrier, so that no rank's collectives count
    the time it waits for a peer still starting its profiler.  With
    ``copies``, also ``h2d_copies`` and ``h2d_copy_ms``: the copies from
    page-locked host memory to the card that ran in the window, from any
    thread of the process, and their device ms.  With ``counts``, also
    ``launches_by_name``: each kernel name's launches in the window.
    ``({}, {})`` when the profiler recorded no device activity."""
    import torch

    wall = []

    def call():
        if start is not None:
            start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))

    events = device_events(call)
    if not events:
        return {}, {}
    nccl = [e for e in events if "nccl" in e.name.lower()]
    comp = [e for e in events if "nccl" not in e.name.lower()]
    busy, nccl_ms, comp_ms = union_ms(events), union_ms(nccl), \
        union_ms(comp)
    split = {"device_busy_ms": busy, "nccl_ms": nccl_ms,
             "compute_ms": comp_ms, "overlap_ms": nccl_ms + comp_ms - busy,
             "call_ms": wall[0]}
    if counts:
        split["launches_by_name"] = {}
        for e in events:
            split["launches_by_name"][e.name] = \
                split["launches_by_name"].get(e.name, 0) + 1
    if copies:
        h2d = [e for e in events if "HtoD" in e.name and "Pinned" in e.name]
        split.update(h2d_copies=len(h2d), h2d_copy_ms=sum(
            e.time_range.elapsed_us() for e in h2d) / 1e3)
    return by_kernel_name(events), split


def h2d_from_trace(streams, columns, bytes_per_batch):
    """The H2D copies' device ms per batch and GB/s, from the pinned
    copies a ``device_profile(..., copies=True)`` window recorded (one
    copy per column of a batch); "not measured" when it recorded none."""
    if not streams.get("h2d_copies"):
        return {"h2d_copy_ms_per_batch": "not measured",
                "h2d_copy_gb_per_s": "not measured", "h2d_traced_batches": 0}
    batches = streams["h2d_copies"] / columns
    return {"h2d_copy_ms_per_batch": streams["h2d_copy_ms"] / batches,
            "h2d_copy_gb_per_s": bytes_per_batch * batches
            / streams["h2d_copy_ms"] / 1e6,
            "h2d_traced_batches": batches}


def idle_share(streams, wall_ms):
    """``{"idle_share": 1 - busy / wall_ms}`` of a ``device_profile``
    split: the share of ``wall_ms`` in which no kernel ran, on any
    stream; "not measured" (busy ms too) when the split is empty."""
    if not streams:
        return {"device_busy_ms": "not measured",
                "idle_share": "not measured"}
    return {"idle_share": 1 - streams["device_busy_ms"] / wall_ms}


def device_ms_by_class(by_name):
    """Device ms (``device_times``) summed by class of kernel name: the
    flash kernels, the GEMMs, NCCL's collectives, and the rest."""
    by_class = {}
    for n, ms in by_name.items():
        c = ("attention kernels (K1-K3)" if "flash_" in n else
             "matmul" if any(x in n for x in ("gemm", "nvjet", "cutlass",
                                               "xmma", "sm90_")) else
             "collectives (NCCL)" if "nccl" in n.lower() else
             "elementwise, copy and reduction")
        by_class[c] = by_class.get(c, 0.0) + ms
    return by_class


def rank_kernels(by_name):
    """Device time by kernel name (``device_times``) as ``(busy_ms, the
    eight longest kernels [[name, ms], ...])``, or "not measured" when the
    profiler recorded no device activity."""
    if not by_name:
        return "not measured", []
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return sum(by_name.values()), [[n[:80], ms] for n, ms in ranked]


def profile_decode_window(eng, vocab_size, start=None):
    """Where a decode window's time goes: one window of ``eng.K`` steps over
    all slots under the profiler (``device_profile``: kernel time by
    name, busy ms as the union over streams, NCCL's kernels apart;
    ``start`` runs first inside its window), then an identical window
    without it (wall time).  The idle share is 1 - busy ms / unprofiled
    wall time.  Fails if the profiler records no device activity."""
    import numpy as np
    import torch

    from ray_tpu_torch.llm import SamplingParams

    rng = np.random.default_rng(7)
    sp = SamplingParams(temperature=0.0, max_tokens=3 * eng.K + 1)
    for _ in range(eng.B):
        eng.submit(rng.integers(3, vocab_size, size=100).tolist(), sp)
    eng.step()  # admissions and the first window
    by_name, streams = device_profile(eng.step, start=start)
    if not streams:
        raise AssertionError("the profiler recorded no device activity in "
                             "a decode window")
    kernel_sum_ms, top = rank_kernels(by_name)
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    while eng.has_unfinished():
        eng.step()
    busy_ms = streams["device_busy_ms"]
    return {"window_steps": eng.K, "slots": eng.B,
            "unprofiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "kernel_sum_ms": kernel_sum_ms, "nccl_ms": streams["nccl_ms"],
            "profiled_call_ms": streams["call_ms"],
            "idle_share": 1 - busy_ms / wall_ms, "top_kernels_ms": top}


def _post(port, path, body, timeout=300):
    """One JSON request to the serve proxy; the decoded answer."""
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _post_sse(port, path, body, timeout=300):
    """One Server-Sent Events request to the serve proxy: its chunks, the
    seconds to the first chunk and to the last."""
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json",
                 "Accept": "text/event-stream"}, method="POST")
    t0 = time.perf_counter()
    chunks, ttft = [], None
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        for line in resp:
            if line.startswith(b"event: error"):
                raise AssertionError(f"{path}: the stream failed: "
                                     f"{resp.read()[:2000]!r}")
            if line.startswith(b"data: "):
                if ttft is None:
                    ttft = time.perf_counter() - t0
                chunks.append(json.loads(line[len(b"data: "):]))
    return chunks, ttft, time.perf_counter() - t0


def _streamed_answer(chunks, what):
    """The done chunk's answer; fails unless the text chunks, in index
    order, add up to its text."""
    done = chunks[-1] if chunks else {}
    parts = chunks[:-1]
    if not done.get("done") or [c["index"] for c in parts] != \
            list(range(len(parts))) or "".join(
                c["text"] for c in parts) != done["generated_text"]:
        raise AssertionError(f"{what}: chunks {chunks[:3]}... do not add "
                             f"up to the done chunk {done}")
    return {k: done[k] for k in ("generated_text", "num_generated_tokens")}


def _answers_equal(got, want, what):
    if got != want:
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        raise AssertionError(f"{what}: requests {bad} differ: "
                             f"{[got[i] for i in bad]} against "
                             f"{[want[i] for i in bad]}")


def llm_bodies(vocab_size):
    """The serve phase's five prompts as token-id lists, greedy, its new
    tokens."""
    return [{"prompt": p, "max_tokens": SERVE_NEW_TOKENS, "temperature": 0.0}
            for p in serve_prompts(vocab_size)]


def phase_llm_server(cfg, params, smi):
    """``LLMServer`` as a deployment: ``serve.start`` (the HTTP proxy on a
    free loopback port), ``serve.run(build_llm_deployment(...))`` with
    Llama-2-7B by name (bf16 weights from seed 0 built in the replica
    process, on ``cuda:0``).  Cold, the five serve prompts one at a time
    over HTTP as SSE streams: each stream's chunks must add up to its
    text, and each answer must equal an in-process ``LLMEngine`` of the
    same settings on this process's same-seed weights fed the prompts
    one at a time (timed: ``in_process_e2e_s``).  Warm (the prefix cache
    holds the prompts), the five
    one at a time as unary HTTP requests, then the first again as a
    stream, which must equal its unary answer; then the five at once
    through the handle.  Reports the replica's start; per request the
    time to first token and end to end as the replica records them
    (from submission) and the client's seconds to the first streamed
    chunk (a chunk waits for text that decodes whole) and to the last;
    the engine steps of the sequential and the concurrent five, the
    decode rate, and the K1-K4 launches of the replica process since its
    engine was built, from the replica's stats after the requests."""
    import torch

    from ray_tpu_torch import serve
    from ray_tpu_torch._private.net import free_port
    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.llm.serving import _build_engine, build_llm_deployment

    bodies = llm_bodies(cfg.vocab_size)
    ref = _build_engine({**LLM_ENGINE_KW, "params": params}, 1)
    sp = SamplingParams(temperature=0.0, max_tokens=SERVE_NEW_TOKENS,
                        stop_token_id=ref.tokenizer.eos_id)
    want, ref_s = [], []
    for b in bodies:
        t0 = time.perf_counter()
        out = ref.generate([b["prompt"]], sp)[0]
        ref_s.append(time.perf_counter() - t0)
        want.append({"generated_text": out.text,
                     "num_generated_tokens": len(out.token_ids)})
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    proxy = serve.start(http_options={"host": "127.0.0.1",
                                      "port": free_port()})
    try:
        t0 = time.perf_counter()
        handle = serve.run(build_llm_deployment(LLM_ENGINE_KW),
                           name="llm_server", route_prefix="/llm")
        start_s = time.perf_counter() - t0

        def steps():
            return handle.stats.remote().result(timeout=60)["engine_steps"]

        s0 = steps()
        cold, rows = [], []
        for i, b in enumerate(bodies):
            chunks, ttft, e2e = _post_sse(proxy.port,
                                          "/llm?stream=1&method=stream", b)
            cold.append(_streamed_answer(chunks, f"llm_server request {i}"))
            rows.append({"prompt_tokens": len(b["prompt"]),
                         "first_chunk_s": ttft, "e2e_s": e2e})
        _answers_equal(cold, want, "llm_server: HTTP against the in-process "
                       "engine")
        s1 = steps()
        warm = []
        for i, b in enumerate(bodies):
            t0 = time.perf_counter()
            warm.append(_post(proxy.port, "/llm", b))
            rows[i]["warm_unary_e2e_s"] = time.perf_counter() - t0
        chunks, warm_first, warm_e2e = _post_sse(
            proxy.port, "/llm?stream=1&method=stream", bodies[0])
        _answers_equal([_streamed_answer(chunks, "llm_server warm stream")],
                       warm[:1], "llm_server: the stream against its unary "
                       "answer")
        s2 = steps()
        t0 = time.perf_counter()
        outs = [r.result(timeout=300)
                for r in [handle.remote(b) for b in bodies]]
        concurrent_s = time.perf_counter() - t0
        stats = handle.stats.remote().result(timeout=60)
    finally:
        serve.shutdown()
    if not all(0 < o["num_generated_tokens"] <= SERVE_NEW_TOKENS
               for o in outs):
        raise AssertionError(f"llm_server: concurrent answers {outs}")
    # the replica's own records, in request order: the cold five first
    for row, rec, s in zip(rows, stats["requests"], ref_s):
        row.update(ttft_s=rec["ttft_s"], replica_e2e_s=rec["e2e_s"],
                   in_process_e2e_s=s)
    t = stats["timing"]
    return {"card": smi, "replica_start_s": start_s, "requests": rows,
            "warm_stream_first_chunk_s": warm_first,
            "warm_stream_e2e_s": warm_e2e,
            "engine_steps_sequential": s1 - s0,
            "engine_steps_concurrent": stats["engine_steps"] - s2,
            "concurrent_wall_s": concurrent_s,
            "texts_equal_in_process": True, "stream_equals_unary": True,
            "decode_tokens_per_s": t["decode_tokens"] / t["decode_s"],
            "prefill_tokens_per_s": t["prefill_tokens"] / t["prefill_s"],
            "prefix_cache": stats["prefix_cache"],
            "k1_k2_k3_k4_launches": stats["kernel_launches"],
            "cold": cold, "warm": warm}


def phase_llm_disagg(cfg, colocated, smi):
    """The disaggregated app: ``build_disaggregated_llm_deployment`` with
    one prefill and one decode replica (both on ``cuda:0``, Llama-2-7B by
    name) behind the ingress.  The chunk budget is ``max_len``, so no
    prompt of the phase is chunked and the prefill is ``llm_server``'s
    (bf16 is not token-exact between GEMM shapes).  Cold, the five
    prompts one at a time over HTTP; warm, through
    ``disaggregated_handle().stream``: each answer must equal
    ``llm_server``'s cold and warm one.  The prefill replica must have
    exported and the decode replica adopted every request, nothing may
    fall back to a re-prefill or prefill on the decode side, and every
    hand-off must ride the device tier.  Reports per request TTFT and the
    prefill, export, ship, land and adopt times, and the K1-K4 launches
    of both replica processes since their engines were built."""
    from ray_tpu_torch import serve
    from ray_tpu_torch._private.net import free_port
    from ray_tpu_torch.experimental.channel.transport import TIER_DEVICE
    from ray_tpu_torch.llm.serving import (build_disaggregated_llm_deployment,
                                           disaggregated_handle)
    from ray_tpu_torch.serve.router import DeploymentHandle

    bodies = llm_bodies(cfg.vocab_size)
    kw = {**LLM_ENGINE_KW, "prefill_chunk": SERVE_MAX_LEN}
    proxy = serve.start(http_options={"host": "127.0.0.1",
                                      "port": free_port()})
    try:
        t0 = time.perf_counter()
        serve.run(build_disaggregated_llm_deployment(kw), name="llm_disagg",
                  route_prefix="/llm")
        start_s = time.perf_counter() - t0
        rows, cold, warm = [], [], []
        for b in bodies:
            t0 = time.perf_counter()
            cold.append(_post(proxy.port, "/llm", b))
            rows.append({"prompt_tokens": len(b["prompt"]),
                         "e2e_s": time.perf_counter() - t0})
        _answers_equal(cold, colocated["cold"], "llm_disagg: HTTP against "
                       "llm_server")
        two = disaggregated_handle()
        for i, b in enumerate(bodies):
            t0 = time.perf_counter()
            chunks, ttft = [], None
            for c in two.stream(b):
                ttft = time.perf_counter() - t0 if ttft is None else ttft
                chunks.append(c)
            warm.append(_streamed_answer(chunks, f"llm_disagg stream {i}"))
            rows[i].update(warm_stream_first_chunk_s=ttft,
                           warm_stream_e2e_s=time.perf_counter() - t0)
        _answers_equal(warm, colocated["warm"], "llm_disagg: the streams "
                       "against llm_server's warm answers")
        pre = DeploymentHandle("LLMPrefill").stats.remote().result(timeout=60)
        dec = DeploymentHandle("LLMDecode").stats.remote().result(timeout=60)
    finally:
        serve.shutdown()
    n = 2 * len(bodies)
    tiers = sorted({s["tier"] for s in pre["shipper"].values()})
    faults = []
    if pre["handoff"]["exported"] < n or dec["handoff"]["adopted"] < n:
        faults.append(f"exported {pre['handoff']}, adopted {dec['handoff']}")
    if dec["fallback_reprefills"] or dec["timing"]["prefill_tokens"]:
        faults.append(f"{dec['fallback_reprefills']} fallback re-prefills, "
                      f"{dec['timing']['prefill_tokens']} tokens prefilled "
                      "on the decode side")
    if tiers != [TIER_DEVICE] or any(s.get("degraded") for s in
                                     pre["shipper"].values()):
        faults.append(f"tiers {tiers}, shipper {pre['shipper']}")
    if faults:
        raise AssertionError("llm_disagg: " + "; ".join(faults))
    landed = {h["handoff_id"]: h for h in dec["handoffs"]}
    handoffs = [{**h, **{k: v for k, v in landed.get(h["handoff_id"],
                                                     {}).items()
                         if k != "handoff_id"}}
                for h in pre["handoffs"]]
    t = dec["timing"]
    return {"card": smi, "replicas_start_s": start_s, "requests": rows,
            "prefill_chunk": SERVE_MAX_LEN, "tier": tiers[0],
            "exported": pre["handoff"]["exported"],
            "adopted": dec["handoff"]["adopted"],
            "fallback_reprefills": dec["fallback_reprefills"],
            "texts_equal_llm_server": True, "handoffs": handoffs,
            "decode_tokens_per_s": t["decode_tokens"] / t["decode_s"],
            "k1_k2_k3_k4_launches": {"prefill": pre["kernel_launches"],
                                     "decode": dec["kernel_launches"]},
            "shipper": pre["shipper"], "landing": dec["landing"]}


def llm_batch_prompts(n=LLM_BATCH_ROWS, seed=5):
    """``n`` text prompts of 8-40 words from a seed."""
    import numpy as np

    words = ("the of and to in is was for on that with as by at from his "
             "card light river stone north cloud paper market engine "
             "silver garden winter signal harbor").split()
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(words, size=int(rng.integers(8, 41))))
            for _ in range(n)]


def phase_llm_batch(cfg, params, smi):
    """``build_llm_processor`` over ``from_items`` of ``LLM_BATCH_ROWS``
    text prompts in blocks of ``LLM_BATCH_SIZE`` (``batch_size`` of the
    same: a batch never spans blocks), one actor (``concurrency=1``), its
    engine built in the actor from this process's ``cfg`` and ``params``
    through ``engine_kwargs`` (no other weights).  The rows must equal,
    in order, an in-process engine's ``generate`` on the same batches."""
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.llm.batch import build_llm_processor

    prompts = llm_batch_prompts()
    kw = {k: v for k, v in LLM_ENGINE_KW.items() if k not in ("model", "cfg")}
    sampling = {"temperature": 0.0, "max_tokens": SERVE_NEW_TOKENS}
    _zero_launches()
    t0 = time.perf_counter()
    rows = build_llm_processor(
        rd.from_items([{"prompt": p} for p in prompts],
                      parallelism=LLM_BATCH_ROWS // LLM_BATCH_SIZE),
        engine_kwargs={"cfg": cfg, "params": params, **kw}, concurrency=1,
        batch_size=LLM_BATCH_SIZE, sampling=sampling, num_gpus=1).take_all()
    wall_s = time.perf_counter() - t0
    launches = list(_all_launches())
    eng = LLMEngine(cfg, params, **kw)
    sp = SamplingParams(stop_token_id=eng.tokenizer.eos_id, **sampling)
    want = [o.text for i in range(0, len(prompts), LLM_BATCH_SIZE)
            for o in eng.generate(prompts[i:i + LLM_BATCH_SIZE], sp)]
    got = [r["generated"] for r in rows]
    if [r["prompt"] for r in rows] != prompts or got != want:
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        raise AssertionError(f"llm_batch: {len(rows)} rows, rows {bad} "
                             "differ from the in-process engine's")
    return {"card": smi, "rows": len(rows), "batch_size": LLM_BATCH_SIZE,
            "rows_equal_in_process": True, "wall_s": wall_s,
            "rows_per_s": len(rows) / wall_s,
            "k1_k2_k3_k4_launches": launches,
            "first_row": {"prompt": rows[0]["prompt"],
                          "generated": rows[0]["generated"]},
            "generated_chars": [len(g) for g in got]}


def phase_train(cfg, device="cuda", steps=TRAIN_STEPS, seq=SEQ, warmup=2,
                make_trainer=None, flops=None):
    """``make_trainer(cfg)`` (default ``make_llama_trainer``) with
    ``default_optimizer(warmup=1, decay_steps=1000)`` (the JAX bench's) on
    b=1 random tokens of length ``seq + 1`` from seed 4: ``warmup``
    warm-up steps, then ``steps`` timed steps ended by ``synchronize()``,
    then one step under the profiler (device time by kernel and by class)
    and one optimizer update alone.  Returns step time, tokens/s, MFU of
    ``flops`` per step (default: the JAX bench's count for a Llama
    config) against the bf16 peak, peak memory over the timed steps, the
    K1/K2/K3 launches of the timed steps, and the loss and grad norm of
    each warm-up step and of the last step."""
    import torch

    from ray_tpu_torch.models.training import (default_optimizer,
                                               make_llama_trainer,
                                               tree_leaves)
    from ray_tpu_torch.ops.cuda.flash_attention import (flash_attention_bwd,
                                                        flash_attention_fwd)

    tr = (make_trainer or make_llama_trainer)(cfg, optimizer=default_optimizer(
        warmup=1, decay_steps=1000), device=device)
    t0 = time.perf_counter()
    state = tr.init_state(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, seq + 1),
                                     generator=gen, device=device)}
    losses, grad_norms = [], []
    for _ in range(warmup):  # library handles, allocator, kernel build
        state, m = tr.step(state, batch)
        losses.append(float(m["loss"]))
        grad_norms.append(float(m["grad_norm"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_fwd.launches = 0
    flash_attention_bwd.dq_launches = 0
    flash_attention_bwd.dkv_launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = tr.step(state, batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    launches = {"K1": flash_attention_fwd.launches,
                "K2": flash_attention_bwd.dq_launches,
                "K3": flash_attention_bwd.dkv_launches}
    losses.append(float(m["loss"]))
    grad_norms.append(float(m["grad_norm"]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    by_name, streams = device_profile(lambda: tr.step(state, batch))
    _, top = rank_kernels(by_name)
    by_class = device_ms_by_class(by_name)
    # the optimizer alone: one update of the real state with zero grads
    leaves = tree_leaves(state["params"])
    grads = [torch.zeros_like(p) for p in leaves]
    optimizer_ms = cuda_ms(lambda: tr.optimizer.update(
        grads, state["opt_state"], leaves), 2)
    if flops is None:
        flops = train_flops_per_step(cfg, 1, seq)
    return {"step_ms": 1e3 * step_s, "tokens_per_s": seq / step_s,
            "mfu": flops / step_s / PEAK_FLOPS["bfloat16"],
            "train_flops_per_step": flops, "peak_memory_gb": peak_gb,
            "init_s": init_s, "warmup_steps": warmup, "timed_steps": steps,
            "launches": launches,
            "launches_per_step": {n: c / steps for n, c in launches.items()},
            "losses": losses, "grad_norms": grad_norms,
            "grad_norm": grad_norms[-1],
            "param_types": sorted({type(t).__name__ for t in leaves}),
            **streams, **idle_share(streams, 1e3 * step_s),
            "device_ms_by_class": by_class, "optimizer_ms": optimizer_ms,
            "top_kernels_ms": top}


def check_train(name, run, per_step):
    """A train phase's launches per timed step must be ``per_step``, and
    its losses and grad norms finite."""
    if run["launches_per_step"] != per_step:
        raise AssertionError(f"{name}: launches per step "
                             f"{run['launches_per_step']}, expected "
                             f"{per_step}")
    if not all(math.isfinite(x) for x in [*run["losses"],
                                           *run["grad_norms"]]):
        raise AssertionError(f"{name}: losses {run['losses']}, grad norms "
                             f"{run['grad_norms']}")


def phase_mesh(train_cfg, train, device="cuda", seq=SEQ):
    """``train_cfg``'s train step through a world-1 mesh (``fsdp``
    preset over this process's NCCL group), beside the ``train`` phase's
    run ``train`` from the same seed and tokens."""
    from ray_tpu_torch.models.training import make_llama_trainer
    from ray_tpu_torch.parallel import MESH_PRESETS, create_mesh

    mesh = create_mesh(MESH_PRESETS["fsdp"], device=device)

    def make(cfg, **kw):
        return make_llama_trainer(cfg, mesh, **kw)

    run = phase_train(train_cfg, device=device, steps=MESH_STEPS, seq=seq,
                      warmup=MESH_WARMUP, make_trainer=make)
    if run["param_types"] != ["DTensor"]:
        raise AssertionError(f"mesh: params are {run['param_types']}")
    rel = abs(run["losses"][0] - train["losses"][0]) / abs(
        train["losses"][0])
    if not rel <= 1e-3:
        raise AssertionError(f"mesh: first loss {run['losses'][0]}, "
                             f"train's {train['losses'][0]} (rtol 1e-3)")
    keys = ("step_ms", "device_busy_ms", "idle_share", "peak_memory_gb")
    return {"mesh": str(mesh), "first_loss_rel_diff_vs_train": rel,
            "first_loss_bit_equal_to_train": run["losses"][0]
            == train["losses"][0],
            "train_phase": {k: train[k] for k in keys}, **run}


def mesh4_rank(rank, world, port, queue):
    """One rank of ``phase_mesh4``: joins the NCCL group on card ``rank``,
    runs the trainer on each mesh of ``MESH4_MESHES`` and the ring, and
    puts its results (or its traceback) on ``queue``."""
    import traceback

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    try:
        queue.put((rank, mesh4_body()))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def mesh4_body():
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.models.training import (default_optimizer,
                                               make_llama_trainer)
    from ray_tpu_torch.ops.attention import ring_attention
    from ray_tpu_torch.ops.cuda.flash_attention import flash_attention_fwd
    from ray_tpu_torch.parallel import (MeshConfig, create_mesh,
                                        ensure_process_group,
                                        redistribute_capture)

    ensure_process_group()
    host = dist.new_group(backend="gloo")  # a barrier that runs no kernel
    dev = torch.device("cuda", torch.cuda.current_device())
    # Llama-2-7B at its full 32 layers (fp32 params, bf16 activations):
    # params and AdamW moments sharded four ways fit where one card's 16
    # layers peaked at 62 GB
    cfg = dataclasses.replace(LlamaConfig.llama2_7b(), dtype=torch.bfloat16,
                              param_dtype=torch.float32,
                              remat_policy="save_attn")
    out = {}
    for name, kw in MESH4_MESHES.items():
        mesh = create_mesh(MeshConfig(**kw))
        tr = make_llama_trainer(cfg, mesh, optimizer=default_optimizer(
            warmup=1, decay_steps=1000))
        t0 = time.perf_counter()
        state = tr.init_state(seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        rows = math.prod(n for a, n in zip(mesh.mesh_dim_names, mesh.shape)
                         if a in ("dp", "fsdp"))
        gen = torch.Generator(device=dev).manual_seed(4)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (rows, SEQ + 1),
                                         generator=gen, device=dev)}
        losses = []
        with redistribute_capture() as implicit:
            for _ in range(MESH_WARMUP):
                state, m = tr.step(state, batch)
                losses.append(float(m["loss"]))
        before = _launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(MESH_STEPS):
            state, m = tr.step(state, batch)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / MESH_STEPS
        losses.append(float(m["loss"]))
        launched = [(b - a) / MESH_STEPS
                    for a, b in zip(before, _launch_counts())]
        peak = torch.cuda.max_memory_allocated() / 1e9
        by_name, streams = device_profile(
            lambda: tr.step(state, batch),
            start=lambda: dist.barrier(group=host))
        _, top = rank_kernels(by_name)
        out[name] = {
            "mesh": str(mesh), "init_s": init_s, "step_ms": 1e3 * step_s,
            # against the profiled step's own wall: NCCL's kernels
            # include waits for peers, which the profiler's host cost
            # lengthens, so the timed steps' wall does not bound them
            **streams, **idle_share(streams, streams.get("call_ms")),
            "device_ms_by_class": device_ms_by_class(by_name),
            "top_kernels_ms": top,
            "tokens_per_s": rows * SEQ / step_s, "losses": losses,
            "grad_norm": float(m["grad_norm"]),
            "k1_k2_k3_per_step": launched, "peak_memory_gb": peak,
            "implicit_redistributes": implicit["count"],
            "implicit_redistribute_lines": implicit["lines"][:4],
            "param_types": sorted({type(t).__name__ for t in
                                   state["params"]["layers"].values()})}
        del tr, state, batch
        gc.collect()
        torch.cuda.empty_cache()
    mesh = create_mesh(MeshConfig(dp=1, sp=MESH4_RANKS))
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn((1, MESH4_RING_SEQ, 32, 128), generator=gen,
                           device=dev, dtype=torch.bfloat16)
               for _ in range(3))
    ring = ring_attention(q, k, v, mesh=mesh, causal=True)
    whole, _ = flash_attention_fwd(q, k, v, causal=True)
    local = ring.to_local()
    blk = local.shape[1]
    idx = mesh.get_local_rank("sp")
    want = whole[:, idx * blk:(idx + 1) * blk]
    err = float((local.float() - want.float()).abs().max())
    bad = int(((local.float() - want.float()).abs()
               > 2e-2 + 2e-2 * want.float().abs()).sum())
    out["ring"] = {"seq": MESH4_RING_SEQ, "sp": MESH4_RANKS,
                   "max_abs_err_vs_k1": err, "elements_over_tol": bad,
                   "atol_rtol": 2e-2,
                   "ring_ms": cuda_ms(lambda: ring_attention(
                       q, k, v, mesh=mesh, causal=True), 3),
                   "k1_whole_ms": cuda_ms(lambda: flash_attention_fwd(
                       q, k, v, causal=True), 3)}
    return out


def phase_mesh4(world=MESH4_RANKS, timeout=MESH4_TIMEOUT_S):
    """``world`` ranks (``mesh4_rank``) forked by the worker zygote,
    joined within ``timeout`` seconds (killed past it).  Fails unless every rank
    reports, K1/K2/K3 launch once per layer per step on every rank, the
    losses are finite and the ring agrees with K1 on the whole
    sequence."""
    import queue as queue_mod
    import socket

    from ray_tpu_torch._private import worker_zygote
    from ray_tpu_torch.parallel import ensure_collective_overlap

    # the ranks read the overlap set at their CUDA and NCCL init; inert
    # unless RAY_TPU_COLLECTIVE_OVERLAP=1
    overlap = ensure_collective_overlap()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = worker_zygote.get_context()
    results = ctx.Queue()
    procs = [ctx.Process(target=mesh4_rank, args=(r, world, port, results))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < world:
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"mesh4: {world - len(got)} ranks did "
                                     f"not report within {timeout} s")
            try:
                rank, out = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    raise AssertionError(f"mesh4: ranks {dead} exited "
                                         "without reporting")
                continue
            if "error" in out:
                raise AssertionError(f"mesh4 rank {rank}:\n{out['error']}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    L = 32
    for rank, out in got.items():
        for name in MESH4_MESHES:
            run = out[name]
            if run["k1_k2_k3_per_step"] != [L, L, L]:
                raise AssertionError(f"mesh4 {name} rank {rank}: K1/K2/K3 "
                                     f"per step {run['k1_k2_k3_per_step']}")
            if not all(math.isfinite(x) for x in run["losses"]):
                raise AssertionError(f"mesh4 {name}: losses {run['losses']}")
            if run["param_types"] != ["DTensor"]:
                raise AssertionError(f"mesh4 {name}: {run['param_types']}")
            if run["implicit_redistributes"]:
                raise AssertionError(
                    f"mesh4 {name} rank {rank}: "
                    f"{run['implicit_redistributes']} implicit "
                    f"redistributes: {run['implicit_redistribute_lines']}")
        if out["ring"]["elements_over_tol"]:
            raise AssertionError(f"mesh4 ring rank {rank}: {out['ring']}")
    return {"ranks": world, "layers": L, "phase_s":
            time.perf_counter() - t0, "rank0": got[0],
            "step_ms_by_rank": {name: [got[r][name]["step_ms"]
                                       for r in sorted(got)]
                                for name in MESH4_MESHES},
            "implicit_redistributes_by_rank": {
                name: [got[r][name]["implicit_redistributes"]
                       for r in sorted(got)] for name in MESH4_MESHES},
            "collective_overlap": overlap,
            "ring_max_abs_err_by_rank": [got[r]["ring"]["max_abs_err_vs_k1"]
                                         for r in sorted(got)]}


def train_config():
    """The ``train`` phase's model: Llama-2-7B width cut to
    ``TRAIN_LAYERS`` layers, fp32 params, bf16 activations,
    ``save_attn``."""
    import torch

    from ray_tpu_torch.models.llama import LlamaConfig

    return dataclasses.replace(
        LlamaConfig.llama2_7b(), num_layers=TRAIN_LAYERS,
        param_dtype=torch.float32, dtype=torch.bfloat16,
        remat_policy="save_attn")


def small_train_config():
    """``small_train_reference``'s model: a small Llama with head_dim 64
    and flash attention."""
    from ray_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig.tiny(hidden_size=256, num_heads=4, num_kv_heads=2,
                            max_seq_len=512, attention_impl="flash")


def memory_before_spawn(phase):
    """This process's allocated device memory, which must stay under 1 GB
    before a phase spawns workers onto its card."""
    import torch

    allocated = torch.cuda.memory_allocated()
    if allocated >= 1e9:
        raise AssertionError(f"{phase}: {allocated / 1e9:.2f} GB still "
                             "allocated here before spawning workers")
    return allocated / 1e9


def trainer_loop(config):
    """The ``trainer`` phase's loop, in its one worker process:
    ``phase_train``'s step (``train_config()``, seed 0, tokens from seed
    4, ``default_optimizer(warmup=1, decay_steps=1000)``), two warm-up,
    ``TRAIN_STEPS`` timed and one profiled step, each followed by an
    allreduce of its loss over the run's world-1 NCCL collective group
    and a synchronize.  Reports each step: the loss and whether the
    allreduced loss equals it bit for bit, its wall (the profiled step's
    under the profiler) and for the profiled step busy ms, its K1/K2/K3
    launches and peak memory; the first also when the loop started and
    when the worker's CUDA context was ready.  Then ``TRAIN_STEPS``
    chained steps, timed together with one synchronize at the end as
    ``phase_train`` times them, in one report."""
    t_start = time.time()
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models.training import (default_optimizer,
                                               make_llama_trainer)
    from ray_tpu_torch.util import collective as col

    ctx = train.get_context()
    dev = ctx.get_device()
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    t_cuda = time.time()
    group = ctx.collective_group("nccl")
    cfg = train_config()
    tr = make_llama_trainer(cfg, optimizer=default_optimizer(
        warmup=1, decay_steps=1000), device=dev)
    state = tr.init_state(seed=0)
    gen = torch.Generator(device=dev).manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, SEQ + 1),
                                     generator=gen, device=dev)}
    out = {}

    def step():
        nonlocal state
        state, m = tr.step(state, batch)
        out["loss"] = m["loss"].reshape(1)
        out["reduced"] = col.allreduce(out["loss"], group)

    warmup = 2
    _zero_launches()
    for i in range(warmup + TRAIN_STEPS + 1):
        kind = ("warmup" if i < warmup else
                "timed" if i < warmup + TRAIN_STEPS else "profiled")
        before = _launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if kind == "profiled":
            _, streams = device_profile(step)
            if not streams:
                raise AssertionError("trainer: the profiler recorded no "
                                     "device activity")
            wall = streams["call_ms"]
            busy = streams["device_busy_ms"]
        else:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
            busy = "not measured"
        row = {"step": i, "kind": kind, "loss": float(out["loss"]),
               "allreduced_loss_bit_equal": bool(torch.equal(
                   out["reduced"], out["loss"])),
               "wall_ms": wall, "device_busy_ms": busy,
               "k1_k2_k3": [b - a for a, b in zip(before,
                                                  _launch_counts())],
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        if i == 0:
            row.update(t_loop_start=t_start, t_cuda_ready=t_cuda)
        row["t_report"] = time.time()
        train.report(row)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        step()
    torch.cuda.synchronize()
    train.report({"kind": "chained", "loss": float(out["loss"]),
                  "step_ms": 1e3 * (time.perf_counter() - t0) / TRAIN_STEPS})


def phase_trainer(train_run):
    """``TorchTrainer(trainer_loop)`` on one worker with the card
    (``use_gpu=True``), beside the ``train`` phase's run ``train_run``.
    Fails unless the run ends without error, K1, K2 and K3 launch once
    per layer per step, the first loss equals ``train``'s within rtol
    1e-5 (whether bit-equal is printed) and every allreduced loss equals
    its loss bit for bit.  Prints the worker's start (``fit()`` to its
    CUDA context), ``fit()`` to the first report, the controller's
    overhead per step (the interval between two timed steps' reports
    less the worker's step wall), the idle share of the timed steps'
    wall by the profiled step's busy time, and the chained steps' wall
    beside ``train``'s."""
    import torch

    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    allocated = memory_before_spawn("trainer")
    t_fit = time.time()
    result = TorchTrainer(trainer_loop, scaling_config=ScalingConfig(
        num_workers=1, use_gpu=True)).fit()
    fit_s = time.time() - t_fit
    if result.error is not None:
        raise AssertionError(f"trainer: {result.error}")
    rows = result.metrics_history
    chained = rows.pop()
    timed = [r for r in rows if r["kind"] == "timed"]
    first = timed[0]["step"]
    intervals = [b["t_report"] - a["t_report"]
                 for a, b in zip(rows[first - 1:], timed)]
    step_ms = sum(r["wall_ms"] for r in timed) / len(timed)
    launches = {k: sum(r["k1_k2_k3"][i] for r in timed)
                for i, k in enumerate(("K1", "K2", "K3"))}
    loss0 = rows[0]["loss"]
    rel = abs(loss0 - train_run["losses"][0]) / abs(train_run["losses"][0])
    profiled = rows[-1]
    out = {
        "workers": 1, "allocated_before_spawn_gb": allocated,
        "worker_start_s": rows[0]["t_cuda_ready"] - t_fit,
        "fit_to_first_report_s": rows[0]["t_report"] - t_fit,
        "controller_overhead_ms_per_step":
            1e3 * sum(intervals) / len(intervals) - step_ms,
        "fit_s": fit_s, "step_ms": step_ms,
        "tokens_per_s": SEQ / step_ms * 1e3,
        "device_busy_ms": profiled["device_busy_ms"],
        "idle_share": 1 - profiled["device_busy_ms"] / step_ms,
        "profiled_step_wall_ms": profiled["wall_ms"],
        "chained_step_ms": chained["step_ms"],
        "train_phase": {k: train_run[k] for k in (
            "step_ms", "device_busy_ms", "idle_share")},
        "launches": launches,
        "launches_per_step": {k: c / len(timed) for k, c in launches.items()},
        "losses": [r["loss"] for r in rows],
        "first_loss_rel_diff_vs_train": rel,
        "first_loss_bit_equal_to_train": loss0 == train_run["losses"][0],
        "allreduced_losses_bit_equal": all(r["allreduced_loss_bit_equal"]
                                           for r in rows),
        "peak_memory_gb": max(r["peak_memory_gb"] for r in rows),
        "steps": [{k: v for k, v in r.items() if not k.startswith("t_")}
                  for r in rows]}
    check_train("trainer", {**out, "grad_norms": []},
                {"K1": TRAIN_LAYERS, "K2": TRAIN_LAYERS, "K3": TRAIN_LAYERS})
    if not rel <= 1e-5:
        raise AssertionError(f"trainer: first loss {loss0}, train's "
                             f"{train_run['losses'][0]} (rtol 1e-5)")
    if not out["allreduced_losses_bit_equal"]:
        raise AssertionError(f"trainer: an allreduced loss differs from "
                             f"its loss: {out['steps']}")
    return out


def data_trainer_rows(vocab_size, rows=DATA_TRAINER_ROWS):
    """The ``data_trainer`` dataset's token rows, ``[rows, SEQ + 1]``
    int64 on the host: the first is exactly the batch ``trainer_loop``
    draws (seed 4 on the card, moved to the host), the rest from numpy's
    generator seeded 5."""
    import numpy as np
    import torch

    gen = torch.Generator(device="cuda").manual_seed(4)
    first = torch.randint(0, vocab_size, (1, SEQ + 1), generator=gen,
                          device="cuda").cpu().numpy()
    rest = np.random.default_rng(5).integers(
        0, vocab_size, (rows - 1, SEQ + 1), dtype=np.int64)
    return np.concatenate([first, rest])


def _landed_row(tokens):
    return {"sum": int(tokens.sum()), "shape": list(tokens.shape),
            "dtype": str(tokens.dtype), "device": str(tokens.device)}


def data_trainer_loop(config):
    """The ``data_trainer`` phase's loop, in its one worker process:
    ``trainer_loop``'s model, optimizer and seed (``train_config()``,
    seed 0), its batches read from the run's ``train`` dataset shard
    through ``iter_torch_batches(batch_size=1, prefetch_batches=2)``: two
    warm-up, ``TRAIN_STEPS`` timed and one profiled step, one batch each,
    then the shard's remaining batches.  Reports each step: the loss, its
    wall (the profiled step's under the profiler, its batch's fetch
    included, with its busy ms and the pinned H2D copies the trace
    recorded), how long ``next`` waited for its batch, its K1/K2/K3
    launches and the landed batch's int64 sum, shape, dtype and device;
    then one row with
    the remaining batches' sums and shapes, the shard's ingest stats and
    the segment its split channel used; the first row also when the loop
    started."""
    t_start = time.time()
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models.training import (default_optimizer,
                                               make_llama_trainer)

    ctx = train.get_context()
    dev = ctx.get_device()
    cfg = train_config()
    tr = make_llama_trainer(cfg, optimizer=default_optimizer(
        warmup=1, decay_steps=1000), device=dev)
    state = tr.init_state(seed=0)
    shard = train.get_dataset_shard("train")
    batches = shard.iter_torch_batches(batch_size=1, prefetch_batches=2)
    out = {}
    _zero_launches()
    kinds = ["warmup"] * 2 + ["timed"] * TRAIN_STEPS + ["profiled"]
    for i, kind in enumerate(kinds):
        torch.cuda.synchronize()

        def fetch():
            t0 = time.perf_counter()
            out["tokens"] = next(batches)["data"]
            out["blocked_ms"] = 1e3 * (time.perf_counter() - t0)

        def step():
            nonlocal state
            state, m = tr.step(state, {"tokens": out["tokens"]})
            out["loss"] = m["loss"]

        before = _launch_counts()
        h2d = {}
        if kind == "profiled":
            # the batch is fetched in the window too: the stager copies
            # the next batch as soon as this one is taken
            _, streams = device_profile(lambda: (fetch(), step()),
                                        copies=True)
            if not streams:
                raise AssertionError("data_trainer: the profiler recorded "
                                     "no device activity")
            wall, busy = streams["call_ms"], streams["device_busy_ms"]
            h2d = {k: streams[k] for k in ("h2d_copies", "h2d_copy_ms")}
        else:
            fetch()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall, busy = 1e3 * (time.perf_counter() - t0), "not measured"
        train.report({"step": i, "kind": kind, "loss": float(out["loss"]),
                      "wall_ms": wall, "device_busy_ms": busy,
                      "consumer_blocked_ms": out["blocked_ms"],
                      "k1_k2_k3": [b - a for a, b in zip(
                          before, _launch_counts())],
                      "landed": _landed_row(out["tokens"]), **h2d,
                      **({"t_loop_start": t_start} if i == 0 else {})})
    rest = [_landed_row(b["data"]) for b in batches]
    train.report({"kind": "ingest", "rest": rest,
                  "stats": shard.ingest_stats.to_dict(),
                  "segment": shard._source.name})


def phase_data_trainer(trainer_run):
    """The ``trainer`` phase's step fed by the data plane:
    ``TorchTrainer(data_trainer_loop, datasets={"train": ds})`` on one
    worker with the card, where ``ds`` is ``from_numpy`` of
    ``data_trainer_rows`` (its first row ``trainer``'s batch).  Fails
    unless the run ends without error, the first loss is bit-equal to
    ``trainer``'s, K1, K2 and K3 launch once per layer per timed step,
    every landed batch (all ``DATA_TRAINER_ROWS``) has its host row's
    int64 sum and shape on ``cuda:0``, and the split's segment is gone
    after ``fit()``.  Prints the H2D copy's device ms per batch (from the
    profiled step's trace) and the stager's host ms, the time the loop waited
    for each batch, the step wall beside ``trainer``'s and the idle
    share of the timed steps' wall by the profiled step's busy time."""
    import ray_tpu_torch.data as td
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    allocated = memory_before_spawn("data_trainer")
    rows = data_trainer_rows(train_config().vocab_size)
    t_fit = time.time()
    result = TorchTrainer(
        data_trainer_loop, datasets={"train": td.from_numpy(rows)},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True)).fit()
    fit_s = time.time() - t_fit
    if result.error is not None:
        raise AssertionError(f"data_trainer: {result.error}")
    steps = result.metrics_history
    ingest = steps.pop()
    timed = [r for r in steps if r["kind"] == "timed"]
    step_ms = sum(r["wall_ms"] for r in timed) / len(timed)
    launches = {k: sum(r["k1_k2_k3"][i] for r in timed)
                for i, k in enumerate(("K1", "K2", "K3"))}
    landed = [r["landed"] for r in steps] + ingest["rest"]
    want = [{"sum": int(row.sum()), "shape": [1, SEQ + 1],
             "dtype": "torch.int64", "device": "cuda:0"} for row in rows]
    stats = ingest["stats"]
    profiled = steps[-1]
    loss0 = steps[0]["loss"]
    out = {
        "workers": 1, "allocated_before_spawn_gb": allocated,
        "dataset": {"rows": len(rows), "row_shape": [SEQ + 1],
                    "dtype": "int64", "blocks": 1,
                    "batch": "iter_torch_batches(batch_size=1, "
                             "prefetch_batches=2)"},
        "worker_start_s": steps[0]["t_loop_start"] - t_fit,
        "fit_s": fit_s, "step_ms": step_ms,
        "trainer_step_ms": trainer_run["step_ms"],
        "step_ms_minus_trainer": step_ms - trainer_run["step_ms"],
        "device_busy_ms": profiled["device_busy_ms"],
        "idle_share": 1 - profiled["device_busy_ms"] / step_ms,
        "trainer_idle_share": trainer_run["idle_share"],
        "consumer_blocked_ms_per_step": [r["consumer_blocked_ms"]
                                         for r in steps],
        **h2d_from_trace(profiled, 1, (SEQ + 1) * 8),
        "h2d_host_ms_per_batch": 1e3 * stats["h2d_s"]
        / max(1, stats["batches"]),
        "h2d_bytes_per_batch": stats["h2d_bytes"]
        / max(1, stats["h2d_batches"]),
        "pinned_bytes": stats["pinned_bytes"],
        "ingest_stats": {k: v for k, v in stats.items() if k != "iterator"},
        "launches": launches,
        "launches_per_step": {k: c / len(timed) for k, c in launches.items()},
        "losses": [r["loss"] for r in steps],
        "first_loss_bit_equal_to_trainer": loss0 == trainer_run["losses"][0],
        "landed_batches_equal_host_rows": landed == want,
        "landed_batches": len(landed),
        "segment_left_after_fit": os.path.exists(
            f"/dev/shm/{ingest['segment']}"),
        "steps": steps}
    check_train("data_trainer", {**out, "grad_norms": []},
                {"K1": TRAIN_LAYERS, "K2": TRAIN_LAYERS, "K3": TRAIN_LAYERS})
    if not out["first_loss_bit_equal_to_trainer"]:
        raise AssertionError(f"data_trainer: first loss {loss0}, trainer's "
                             f"{trainer_run['losses'][0]} (bit-equal)")
    if not out["landed_batches_equal_host_rows"]:
        raise AssertionError(f"data_trainer: landed {landed}, the host "
                             f"rows {want}")
    if out["segment_left_after_fit"]:
        raise AssertionError(f"data_trainer: segment {ingest['segment']} "
                             "outlived fit()")
    return out


def resume_setup(dev):
    """``trainer_resume``'s model, trainer, fresh state and batch on
    ``dev``: ``small_train_config()``, params from seed 5, tokens from
    seed 6, ``default_optimizer(lr=1e-3, warmup=1, decay_steps=10)``."""
    import torch

    from ray_tpu_torch.models.training import (default_optimizer,
                                               make_llama_trainer)

    cfg = small_train_config()
    tokens = torch.randint(0, cfg.vocab_size, (2, 301),
                           generator=torch.Generator().manual_seed(6)).to(dev)
    tr = make_llama_trainer(cfg, optimizer=default_optimizer(
        lr=1e-3, warmup=1, decay_steps=10), device=dev)
    return tr, tr.init_state(seed=5), {"tokens": tokens}


def resume_loop(config):
    """The ``trainer_resume`` phase's loop: ``resume_setup``'s model on
    the card, ``RESUME_STEPS`` steps on one batch, each reported with a
    ``Checkpoint.from_state_dict`` of the params, the AdamW state and the
    step.  The first attempt raises at step ``RESUME_FAIL_AT``; a
    restarted attempt resumes from the latest checkpoint
    (``to_state_dict`` onto a fresh state's devices).  Each row carries
    when its attempt's loop started and when it was reported."""
    t_start = time.time()
    from ray_tpu_torch import train
    from ray_tpu_torch.models.training import tree_leaves

    ctx = train.get_context()
    tr, state, batch = resume_setup(ctx.get_device())
    ck = ctx.get_checkpoint()
    if ck is not None:
        state = ck.to_state_dict(target=state)
        for t in tree_leaves(state["params"]):
            t.requires_grad_(True)
    attempt = "first" if ck is None else "resumed"
    _zero_launches()
    for step in range(state["step"], RESUME_STEPS):
        if ck is None and step == RESUME_FAIL_AT:
            raise RuntimeError(f"injected failure at step {step}")
        state, m = tr.step(state, batch)
        saved = train.Checkpoint.from_state_dict(state, path=os.path.join(
            config["dir"], f"{attempt}_step{step}"))
        train.report({"step": step, "loss": float(m["loss"]),
                      "attempt": attempt,
                      "k1_k2_k3": list(_launch_counts()),
                      "t_loop_start": t_start, "t_report": time.time()},
                     checkpoint=saved)


def phase_trainer_resume():
    """``resume_loop`` through ``TorchTrainer`` on the card, failing at
    step ``RESUME_FAIL_AT`` under ``FailureConfig(max_failures=1)``, so
    the restarted group resumes from the step-1 checkpoint; and the same
    steps uninterrupted in this process on the same card.  Fails unless
    the resumed steps' losses and the last checkpoint's tensors equal
    the uninterrupted run's bit for bit, and K1, K2 and K3 launch once
    per layer per step in both attempts."""
    import shutil
    import tempfile

    import torch

    from ray_tpu_torch.models.training import tree_leaves
    from ray_tpu_torch.train import (FailureConfig, RunConfig,
                                     ScalingConfig, TorchTrainer)

    memory_before_spawn("trainer_resume")
    layers = small_train_config().num_layers
    tmp = tempfile.mkdtemp(prefix="trainer_resume_")
    t0 = time.perf_counter()
    t_fit = time.time()
    try:
        result = TorchTrainer(
            resume_loop, train_loop_config={"dir": tmp},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(
                name="trainer_resume", storage_path=tmp,
                failure_config=FailureConfig(max_failures=1))).fit()
        if result.error is not None:
            raise AssertionError(f"trainer_resume: {result.error}")
        got, got_last = result.metrics_history, tree_leaves(
            result.checkpoint.to_state_dict())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fit_s = time.perf_counter() - t0
    tr, state, batch = resume_setup("cuda")
    clean = []
    for _ in range(RESUME_STEPS):
        state, m = tr.step(state, batch)
        clean.append(float(m["loss"]))
    want_last = [t.detach().cpu() if isinstance(t, torch.Tensor) else t
                 for t in tree_leaves(state)]
    del tr, state, batch
    attempts = [(r["step"], r["attempt"]) for r in got]
    expect = [(s, "first" if s < RESUME_FAIL_AT else "resumed")
              for s in range(RESUME_STEPS)]
    if attempts != expect:
        raise AssertionError(f"trainer_resume: steps and attempts "
                             f"{attempts}, expected {expect}")
    resumed = [r["loss"] for r in got[RESUME_FAIL_AT:]]
    tensors_equal = len(got_last) == len(want_last) and all(
        torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
        for a, b in zip(got_last, want_last))
    per_step = {}
    for attempt in ("first", "resumed"):
        rows = [r for r in got if r["attempt"] == attempt]
        per_step[attempt] = [c / len(rows) for c in rows[-1]["k1_k2_k3"]]
    out = {"model": "small Llama (small_reference's)", "layers": layers,
           "steps": RESUME_STEPS, "fail_at": RESUME_FAIL_AT,
           "losses_interrupted": [r["loss"] for r in got],
           "losses_uninterrupted": clean,
           "resumed_losses_bit_equal": resumed == clean[RESUME_FAIL_AT:],
           "last_checkpoint_bit_equal": tensors_equal,
           "k1_k2_k3_per_step_by_attempt": per_step,
           "launches": {k: got[RESUME_FAIL_AT - 1]["k1_k2_k3"][i]
                        + got[-1]["k1_k2_k3"][i]
                        for i, k in enumerate(("K1", "K2", "K3"))},
           "worker_start_s": got[0]["t_loop_start"] - t_fit,
           # the failure's last report to the restarted worker's loop
           "restart_s": got[RESUME_FAIL_AT]["t_loop_start"]
           - got[RESUME_FAIL_AT - 1]["t_report"],
           "fit_s": fit_s, "phase_s": time.perf_counter() - t0}
    if not (out["resumed_losses_bit_equal"] and tensors_equal):
        raise AssertionError(f"trainer_resume: the resumed run differs from "
                             f"the uninterrupted one: {out}")
    if any(c != [layers] * 3 for c in per_step.values()):
        raise AssertionError(f"trainer_resume: K1/K2/K3 per step "
                             f"{per_step}, expected {layers} each")
    return out


def trainer4_loop(config):
    """One rank of ``trainer4``: ``mesh4``'s ``fsdp4`` case through the
    session (Llama-2-7B at full depth, params from seed 0 placed by
    ``shard_params`` on the ``fsdp`` preset's mesh, this rank's row of
    the seed-4 batch by ``shard_inputs``), then the four-rank NCCL
    collective group on ``TRAINER4_COLLECTIVE_BYTES`` of integer-valued
    fp32 per rank: allreduce, allgather, reducescatter and broadcast,
    each held bit for bit to the result on the host, then timed by CUDA
    events over ``TRAINER4_COLLECTIVE_ITERS`` calls entered together
    (each op clones its input first).  Raises on
    any mismatch; rank 0's report is the run's."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models.llama import (LlamaConfig, llama_init,
                                            llama_param_specs)
    from ray_tpu_torch.models.training import (default_optimizer,
                                               make_llama_trainer)
    from ray_tpu_torch.util import collective as col

    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    dev = ctx.get_device()
    mesh = ctx.get_mesh()
    cfg = dataclasses.replace(LlamaConfig.llama2_7b(), dtype=torch.bfloat16,
                              param_dtype=torch.float32,
                              remat_policy="save_attn")
    tr = make_llama_trainer(cfg, mesh, optimizer=default_optimizer(
        warmup=1, decay_steps=1000))
    state = tr.init_state(params=ctx.shard_params(
        llama_init(cfg, seed=0, device=dev), llama_param_specs(cfg)))
    gen = torch.Generator(device=dev).manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (world, SEQ + 1),
                           generator=gen, device=dev)
    batch = ctx.shard_inputs({"tokens": tokens[rank:rank + 1]})
    losses = []
    for _ in range(MESH_WARMUP):
        state, m = tr.step(state, batch)
        losses.append(float(m["loss"]))
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MESH_STEPS):
        state, m = tr.step(state, batch)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / MESH_STEPS
    losses.append(float(m["loss"]))
    per_step = [c / MESH_STEPS for c in _launch_counts()]
    if per_step != [cfg.num_layers] * 3:
        raise AssertionError(f"trainer4 rank {rank}: K1/K2/K3 per step "
                             f"{per_step}")
    del tr, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    group = ctx.collective_group("nccl")
    n = TRAINER4_COLLECTIVE_BYTES // 4
    inputs = [torch.randint(-64, 64, (n,), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(
                                100 + r)).float() for r in range(world)]
    mine = inputs[rank]
    host = [x.cpu() for x in inputs]
    total = sum(host[1:], host[0].clone())
    ops = {
        "allreduce": (lambda: col.allreduce(mine, group),
                      lambda out: torch.equal(out.cpu(), total)),
        "allgather": (lambda: col.allgather(mine, group),
                      lambda outs: all(torch.equal(o.cpu(), h)
                                       for o, h in zip(outs, host))),
        "reducescatter": (lambda: col.reducescatter(mine, group),
                          lambda out: torch.equal(
                              out.cpu(), total.chunk(world)[rank])),
        "broadcast": (lambda: col.broadcast(mine, 0, group),
                      lambda out: torch.equal(out.cpu(), host[0])),
    }
    collectives = {}
    for name, (fn, check) in ops.items():
        if not check(fn()):
            raise AssertionError(f"trainer4 rank {rank}: {name} differs "
                                 "from the host's result")
        # every rank enters the timed calls together: a barrier on the
        # group, waited for on the host
        col.barrier(group)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TRAINER4_COLLECTIVE_ITERS):
            fn()
        end.record()
        end.synchronize()
        collectives[name] = {"ms": start.elapsed_time(end)
                             / TRAINER4_COLLECTIVE_ITERS, "bit_equal": True}
    train.report({"rank": rank, "mesh": str(mesh), "losses": losses,
                  "step_ms": step_ms, "k1_k2_k3_per_step": per_step,
                  "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "collective_bytes_per_rank": TRAINER4_COLLECTIVE_BYTES,
                  "collectives": collectives})


def phase_trainer4(mesh4):
    """``TorchTrainer(trainer4_loop)`` over ``MESH4_RANKS`` workers, one
    card each, on the ``fsdp`` preset.  Fails unless the run ends without
    error (each rank checks its launches and collectives) and its first
    loss equals ``mesh4``'s ``fsdp4`` first loss within rtol 1e-5."""
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    memory_before_spawn("trainer4")
    t0 = time.perf_counter()
    result = TorchTrainer(trainer4_loop, scaling_config=ScalingConfig(
        num_workers=MESH4_RANKS, use_gpu=True, mesh="fsdp")).fit()
    if result.error is not None:
        raise AssertionError(f"trainer4: {result.error}")
    got = result.metrics
    want = mesh4["rank0"]["fsdp4"]["losses"][0]
    rel = abs(got["losses"][0] - want) / abs(want)
    out = {"ranks": MESH4_RANKS, "layers": 32, **got,
           "mesh4_fsdp4_first_loss": want,
           "first_loss_rel_diff_vs_mesh4": rel,
           "first_loss_bit_equal_to_mesh4": got["losses"][0] == want,
           "mesh4_fsdp4_step_ms": mesh4["rank0"]["fsdp4"]["step_ms"],
           "phase_s": time.perf_counter() - t0}
    if not rel <= 1e-5:
        raise AssertionError(f"trainer4: first loss {got['losses'][0]}, "
                             f"mesh4's {want} (rtol 1e-5)")
    return out


def serve_mesh4_rank(rank, world, port, queue, prompts, cfg):
    """One rank of ``phase_serve_mesh4``: joins the NCCL group on card
    ``rank``, serves ``prompts`` on each mesh of ``SERVE_MESH4_MESHES``
    and puts its results (or its traceback) on ``queue``."""
    import traceback

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    try:
        queue.put((rank, serve_mesh4_body(prompts, cfg)))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def serve_mesh4_body(prompts, cfg):
    """``cfg`` (Llama-2-7B in bf16 weights from seed 0, at full depth)
    served on each mesh of ``SERVE_MESH4_MESHES`` by ``serve_run``:
    tokens, the logits of the first admissions and of the first decode
    step, decode tokens/s, this rank's weight and pool bytes and peak
    memory, and NCCL's ms per decode step in the profiled window (each
    rank enters it through a gloo barrier)."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.llm import LLMEngine
    from ray_tpu_torch.models.llama import llama_init
    from ray_tpu_torch.parallel import (MeshConfig, create_mesh,
                                        ensure_process_group)

    ensure_process_group("cuda")
    host = dist.new_group(backend="gloo")  # a barrier that runs no kernel
    dev = torch.device("cuda", torch.cuda.current_device())
    params = llama_init(cfg, seed=0, device=dev)
    out = {}
    for name, kw in SERVE_MESH4_MESHES.items():
        mesh = create_mesh(MeshConfig(**kw), device="cuda")
        eng = LLMEngine(cfg, params, batch_slots=SERVE_SLOTS,
                        max_len=SERVE_MAX_LEN, block_size=SERVE_BLOCK,
                        seed=0, mesh=mesh, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run = serve_run(eng, cfg, prompts,
                        start=lambda: dist.barrier(group=host))
        prof = run["decode_profile"]
        out[name] = {
            "mesh": str(mesh), **{k: run[k] for k in (
                "token_ids", "decode_tokens_per_s", "prefill_ms", "wall_s",
                "k1_k2_k3_k4_launches")},
            # numpy: the queue pickles it whole, with no shared memory
            # that must outlive this process
            **{k: run[k].numpy() for k in ("first_token_logits",
                                           "first_decode_logits")},
            "weight_bytes": tree_bytes(eng._lparams),
            "pool_bytes": tree_bytes(eng._lpool),
            "nccl_ms_per_decode_step": prof["nccl_ms"] / prof["window_steps"],
            "decode_profile": prof,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


def fp32_reference(cfg, params, prompts, tokens):
    """What an fp32 forward of the same weights gives for each request's
    ``prompt + [first token]``, for the first ``SERVE_SLOTS`` requests
    (the slots of the first admissions and decode window): the logits of
    its first token (the prompt's last position) and of its first decode
    step (the last position); and for every request the argmax, the top
    two and the top-two margin of its first token.  The weights are cast next to the
    bf16 ones (~27 GB more)."""
    import torch

    from ray_tpu_torch.models.llama import llama_apply

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    p32 = {k: ({n: t.float() for n, t in v.items()} if isinstance(v, dict)
               else v.float()) for k, v in params.items()}
    heads, rows, first = [], [], []
    with torch.no_grad():
        for p, toks in zip(prompts, tokens):
            ctx = torch.tensor([p + toks[:1]], device=params["embed"].device)
            logits = llama_apply(p32, ctx, cfg32)[0, -2:].cpu()
            heads.append(logits[0])
            rows.append(logits[1])
            top = logits[0].topk(2)
            first.append({"argmax": int(top.indices[0]),
                          "top2": top.indices.tolist(), "top2_margin":
                          float(top.values[0] - top.values[1])})
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    return (torch.stack(heads[:SERVE_SLOTS]), torch.stack(rows[:SERVE_SLOTS]),
            first)


def phase_serve_mesh4(cfg, params, single, world=MESH4_RANKS,
                      timeout=SERVE_MESH4_TIMEOUT_S):
    """``world`` ranks (``serve_mesh4_rank``), one per card, forked by the
    worker zygote and joined within ``timeout`` seconds (killed past it),
    serve the ``serve`` phase's requests at full depth on each mesh of
    ``SERVE_MESH4_MESHES``.  ``single`` is the single-card engine's
    ``serve_run``.  Fails unless every rank reports; lists in
    ``failures`` (``check_serve_mesh4`` raises on them) a mesh whose
    ranks disagree; whose first-token logits are farther (max-abs) from
    an fp32 forward of the same weights than twice the single-card bf16
    engine's distance from it (the bound); whose first token differs
    from the single card's where fp32's top-two margin exceeds the bound
    (no rounding within it can flip such a token), or is not one of
    fp32's top two elsewhere; or whose first decode step's logits are
    farther from fp32 than twice the single card's distance, over the
    slots whose first token equals the single card's (a slot whose first
    token differs decodes from another input).  In bf16 a tp mesh sums
    the row-parallel products in another order than one card's GEMM, so
    a first token whose margin lies inside the bound may round either
    way (the CPU test ``test_bf16_mesh_rounds_like_one_rank`` holds the
    same rule).  Reports the greedy tokens
    equal to the single card's, each slot's and request's distances from
    fp32 and from the single card (first token and first decode step),
    decode tokens/s, per-rank weight and pool bytes and NCCL ms per
    decode step."""
    import queue as queue_mod
    import socket

    import torch

    from ray_tpu_torch._private import worker_zygote

    serve_tokens = single["token_ids"]
    prompts = serve_prompts(cfg.vocab_size)
    ref_first, ref32, first32 = fp32_reference(cfg, params, prompts,
                                               serve_tokens)

    def by_row(a, b):
        return (a - b[:a.shape[0]]).abs().amax(dim=-1)

    single_dist = float(by_row(single["first_decode_logits"], ref32).max())
    single_first = float(by_row(single["first_token_logits"],
                                ref_first).max())
    bound = 2 * single_first
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = worker_zygote.get_context()
    results = ctx.Queue()
    procs = [ctx.Process(target=serve_mesh4_rank,
                         args=(r, world, port, results, prompts, cfg))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < world:
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"serve_mesh4: {world - len(got)} ranks"
                                     f" did not report within {timeout} s")
            try:
                rank, out = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    raise AssertionError(f"serve_mesh4: ranks {dead} exited "
                                         "without reporting")
                continue
            if "error" in out:
                raise AssertionError(f"serve_mesh4 rank {rank}:\n"
                                     f"{out['error']}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    report = {"ranks": world, "layers": cfg.num_layers,
              "phase_s": time.perf_counter() - t0,
              "single_card_max_abs_vs_fp32": single_dist,
              "single_card_first_token_max_abs_vs_fp32": single_first,
              "first_token_bound": bound,
              "single_card_first_token_max_abs_vs_fp32_by_request": by_row(
                  single["first_token_logits"], ref_first).tolist(),
              "single_card_first_tokens": [t[:1] for t in serve_tokens],
              "fp32_first_tokens": first32, "failures": []}
    for name in SERVE_MESH4_MESHES:
        runs = [got[r][name] for r in sorted(got)]
        toks = runs[0]["token_ids"]
        fail = report["failures"].append
        if any(r["token_ids"] != toks for r in runs):
            fail(f"{name}: ranks disagree")
        heads = torch.from_numpy(runs[0]["first_token_logits"])
        first_dist = float(by_row(heads, ref_first).max())
        if not first_dist <= bound:
            fail(f"{name}: first-token logits {first_dist} from the fp32 "
                 f"forward, over twice the single card's {single_first}")
        for i, (tok, one, f32) in enumerate(zip(toks, serve_tokens,
                                                first32)):
            if f32["top2_margin"] > bound:
                if tok[0] != one[0]:
                    fail(f"{name}: request {i}'s first token {tok[0]}, the "
                         f"single card's {one[0]}, where fp32's top-two "
                         f"margin {f32['top2_margin']} exceeds the bound "
                         f"{bound}")
            elif tok[0] not in f32["top2"]:
                fail(f"{name}: request {i}'s first token {tok[0]} is not "
                     f"one of fp32's top two {f32['top2']}")
        agree = [a[:1] == b[:1] for a, b in zip(toks, serve_tokens)]
        decode = torch.from_numpy(runs[0]["first_decode_logits"])
        rows = by_row(decode, ref32)
        compared = [float(d) for d, a in zip(rows, agree) if a]
        dist_mesh = max(compared) if compared else None
        if dist_mesh is None or not dist_mesh <= 2 * single_dist:
            fail(f"{name}: first decode step's logits {dist_mesh} from the "
                 f"fp32 forward over the slots whose first tokens agree "
                 f"({agree[:len(rows)]}), the single card's {single_dist}")
        same = sum(x == y for a, b in zip(toks, serve_tokens)
                   for x, y in zip(a, b))
        report[name] = {
            "mesh": runs[0]["mesh"], "max_abs_vs_fp32": dist_mesh,
            "first_token_max_abs_vs_fp32": first_dist,
            "max_abs_vs_fp32_by_slot": rows.tolist(),
            "slot_first_token_agrees": agree[:len(rows)],
            "max_abs_vs_single_card_by_slot": by_row(
                decode, single["first_decode_logits"]).tolist(),
            "first_token_max_abs_vs_fp32_by_request": by_row(
                heads, ref_first).tolist(),
            "first_token_max_abs_vs_single_card_by_request": by_row(
                heads, single["first_token_logits"]).tolist(),
            "first_tokens": [t[:1] for t in toks],
            "tokens_equal_single_card": same,
            "tokens_total": sum(len(t) for t in serve_tokens),
            "k1_k2_k3_k4_launches_by_rank": [r["k1_k2_k3_k4_launches"]
                                             for r in runs],
            **{k: [r[k] for r in runs] for k in (
                "decode_tokens_per_s", "weight_bytes", "pool_bytes",
                "nccl_ms_per_decode_step", "peak_memory_gb", "wall_s")},
            "rank0_decode_profile": runs[0]["decode_profile"]}
    return report


def check_serve_mesh4(report):
    """Raise on ``phase_serve_mesh4``'s failures, after its line is
    printed (so that a failing run still shows what it measured)."""
    if report["failures"]:
        raise AssertionError("serve_mesh4: " + "; ".join(report["failures"]))


def small_mesh_reference(device="cuda", steps=3):
    """``small_train_reference``'s model, tokens and steps through a
    world-1 mesh on ``device`` (the params DTensors) against the plain
    path on the CPU with no mesh (``train_vs_cpu``); on the card K1, K2
    and K3 must each launch once per layer per step."""
    import torch

    from ray_tpu_torch.models.llama import llama_init
    from ray_tpu_torch.models.training import make_llama_trainer
    from ray_tpu_torch.parallel import MESH_PRESETS, create_mesh

    mesh = create_mesh(MESH_PRESETS["fsdp"], device=device)
    cfg = small_train_config()
    tokens = torch.randint(0, cfg.vocab_size, (2, 301),
                           generator=torch.Generator().manual_seed(6))
    out = train_vs_cpu(cfg, llama_init(cfg, seed=5, device="cpu"),
                       functools.partial(make_llama_trainer, mesh=mesh),
                       tokens, device, steps,
                       make_reference=make_llama_trainer)
    launched = out["train_k1_k2_k3_launches"]
    if device == "cuda" and launched != [steps * cfg.num_layers] * 3:
        raise AssertionError(f"mesh: K1/K2/K3 launched {launched} times in "
                             f"{steps} steps of {cfg.num_layers} layers")
    return out


def phase_moe_forward(device="cuda", want_layers=MOE_FORWARD_LAYERS,
                      seq=SEQ, steps=MOE_FORWARD_STEPS):
    """``moe_apply`` at Mixtral-8x7B width, bf16 weights from seed 0, on
    b=1 random tokens of length ``seq``: ``want_layers`` deep, or the
    deepest depth that leaves ``MOE_RESERVE`` bytes of the card free
    after the forward's transients (``moe_forward_bytes``, printed with
    ``mem_get_info`` before anything is allocated).  One warm-up forward,
    then ``steps`` timed forwards ended by ``synchronize()``, then one
    under the profiler.  K1 must launch once per layer per forward, and
    the logits and aux must be finite and of the expected shape."""
    import torch

    from ray_tpu_torch.models.moe import MoEConfig, moe_apply, moe_init
    from ray_tpu_torch.ops.cuda.flash_attention import flash_attention_fwd

    allocated = torch.cuda.memory_allocated()
    if allocated >= 1e9:
        raise AssertionError(f"{allocated} bytes still allocated before the "
                             "MoE weights (the earlier phases must free "
                             "theirs)")
    base = dataclasses.replace(MoEConfig.mixtral_8x7b(),
                               param_dtype=torch.bfloat16)
    free, total = torch.cuda.mem_get_info()
    layers = next((n for n in range(want_layers, 0, -1)
                   if sum(moe_forward_bytes(base, n, seq).values())
                   + MOE_RESERVE <= free), 0)
    reckoning = {"phase": "moe_forward_reckoning",
                 "mem_get_info_free_gb": free / 1e9,
                 "mem_get_info_total_gb": total / 1e9,
                 "allocated_gb": allocated / 1e9,
                 "full_depth_gb": {k: v / 1e9 for k, v in moe_forward_bytes(
                     base, base.num_layers, seq).items()},
                 "wanted_layers": want_layers, "layers": layers,
                 "at_layers_gb": {k: v / 1e9 for k, v in moe_forward_bytes(
                     base, layers, seq).items()},
                 "reserve_gb": MOE_RESERVE / 1e9}
    emit(reckoning)
    if layers == 0:
        raise AssertionError(f"no depth of Mixtral-8x7B fits the card: "
                             f"{json.dumps(reckoning)}")
    cfg = dataclasses.replace(base, num_layers=layers)
    t0 = time.perf_counter()
    params = moe_init(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen,
                           device=device)
    with torch.no_grad():
        moe_apply(params, tokens, cfg)  # warm-up: library handles, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention_fwd.launches = 0
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, aux = moe_apply(params, tokens, cfg)
        torch.cuda.synchronize()
        forward_s = (time.perf_counter() - t0) / steps
        launches = flash_attention_fwd.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        busy_ms, top = rank_kernels(device_times(
            lambda: moe_apply(params, tokens, cfg)))
    if tuple(logits.shape) != (1, seq, cfg.vocab_size) \
            or logits.dtype != torch.float32 \
            or not bool(torch.isfinite(logits).all()) \
            or not math.isfinite(float(aux)):
        raise AssertionError(f"MoE forward: logits shape "
                             f"{tuple(logits.shape)}, dtype {logits.dtype}, "
                             f"finite {bool(torch.isfinite(logits).all())}, "
                             f"aux {float(aux)}")
    if launches != steps * layers:
        raise AssertionError(f"K1 launched {launches} times in {steps} MoE "
                             f"forwards of {layers} layers")
    dense = moe_forward_flops(cfg, 1, seq, cfg.num_experts)
    active = moe_forward_flops(cfg, 1, seq, cfg.experts_per_token)
    return {"model": "mixtral_8x7b", "layers": layers,
            "depth_cut": MOE_FORWARD_CUT if layers == MOE_FORWARD_LAYERS
            else f"32 → {layers} layers: the deepest that leaves "
                 f"{MOE_RESERVE / 1e9:.0f} GB free on this card",
            "weights_gb": sum(t.numel() * t.element_size() for t in
                              [params["embed"], params["lm_head"],
                               params["final_norm"],
                               *params["layers"].values()]) / 1e9,
            "init_s": init_s, "batch": 1, "seq": seq, "timed_forwards": steps,
            "forward_ms": 1e3 * forward_s, "tokens_per_s": seq / forward_s,
            "k1_launches": launches, "k1_launches_per_forward":
            launches / steps, "peak_memory_gb": peak_gb,
            "device_busy_ms": busy_ms, "top_kernels_ms": top,
            "aux": float(aux), "logits_max_abs": float(logits.abs().max()),
            "dense_dispatch_flops": dense, "active_top2_flops": active,
            "tflops_by_dense_dispatch_flops": dense / forward_s / 1e12,
            "tflops_by_active_top2_flops": active / forward_s / 1e12}


def vit_train_flops_per_image(cfg) -> float:
    """Model FLOPs per image of a ViT train step as the JAX vision bench
    counts them (``benchmarks/vision_train_bench.py:70-77``): 6 per
    matmul parameter use per token (forward 2, backward 4), plus the
    attention's products; the remat replay is not counted."""
    tokens = cfg.num_patches + 1
    per_layer = 4 * cfg.hidden_size ** 2 + 2 * cfg.hidden_size * cfg.mlp_dim
    dense = 6 * (per_layer * cfg.num_layers
                 + cfg.patch_dim * cfg.hidden_size
                 + cfg.hidden_size * cfg.num_classes) * tokens
    attn = 12 * cfg.num_layers * tokens * tokens * cfg.hidden_size
    return float(dense + attn)


def vit_batch(cfg, batch, device, seed):
    """``batch`` random images (standard normal, fp32, [b, H, W, C]) and
    labels from one generator seeded ``seed`` on ``device``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    images = torch.randn((batch, cfg.image_size, cfg.image_size,
                          cfg.num_channels), generator=gen, device=device)
    labels = torch.randint(0, cfg.num_classes, (batch,), generator=gen,
                           device=device)
    return {"images": images, "labels": labels}


def phase_vit_small_reference(device="cuda", steps=3):
    """``ViTConfig.tiny`` in fp32 trains ``steps`` steps on ``device`` and
    on the CPU from the same params (drawn from seed 9, then carried
    through the converter's numpy layout and back) and batch
    (``train_vs_cpu``: losses to rtol 1e-5, grad norms to 1e-4).  The
    attention is 'ref', as the reference pins it: K1, K2 and K3 must not
    launch."""
    import torch

    from ray_tpu_torch.models.convert import (vit_params_from_jax,
                                              vit_params_to_jax)
    from ray_tpu_torch.models.vit import ViTConfig, make_vit_trainer, vit_init

    cfg = ViTConfig.tiny(dtype=torch.float32)
    params = vit_params_from_jax(vit_params_to_jax(vit_init(
        cfg, seed=9, device="cpu")), cfg, device="cpu")
    out = train_vs_cpu(cfg, params, make_vit_trainer,
                       vit_batch(cfg, 8, "cpu", seed=10), device, steps)
    if out["train_k1_k2_k3_launches"] != [0, 0, 0]:
        raise AssertionError(f"ViT: K1/K2/K3 launched "
                             f"{out['train_k1_k2_k3_launches']} times with "
                             "the attention pinned to 'ref'")
    return {"model": "ViT tiny fp32", "steps": steps, **out}


def phase_vit_train(device="cuda", batch=VIT_BATCH, steps=VIT_STEPS,
                    warmup=2):
    """``make_vit_trainer`` at ViT-B/16's published width
    (``ViTConfig.vit_b16()``: bf16 compute, fp32 params and AdamW,
    ``default_optimizer(warmup=1, decay_steps=1000)``) on ``batch``
    random images and labels from seed 4: ``warmup`` warm-up steps,
    ``steps`` timed steps ended by ``synchronize()``, one step under the
    profiler and one optimizer update alone.  Returns step ms, images/s,
    MFU by the vision bench's FLOPs against the bf16 peak, peak memory,
    the idle share, device ms by class and the top kernels; fails unless
    every loss and grad norm is finite and K1, K2 and K3 never launch
    (the attention is 'ref', as the reference's)."""
    import torch

    from ray_tpu_torch.models.training import default_optimizer, tree_leaves
    from ray_tpu_torch.models.vit import ViTConfig, make_vit_trainer

    cfg = ViTConfig.vit_b16()
    tr = make_vit_trainer(cfg, optimizer=default_optimizer(
        warmup=1, decay_steps=1000), device=device)
    t0 = time.perf_counter()
    state = tr.init_state(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    data = vit_batch(cfg, batch, device, seed=4)
    _zero_launches()
    losses, grad_norms = [], []
    for _ in range(warmup):
        state, m = tr.step(state, data)
        losses.append(float(m["loss"]))
        grad_norms.append(float(m["grad_norm"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = tr.step(state, data)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    losses.append(float(m["loss"]))
    grad_norms.append(float(m["grad_norm"]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    by_name, streams = device_profile(lambda: tr.step(state, data))
    if not streams:
        raise AssertionError("vit_train: the profiler recorded no device "
                             "activity")
    _, top = rank_kernels(by_name)
    leaves = tree_leaves(state["params"])
    grads = [torch.zeros_like(p) for p in leaves]
    optimizer_ms = cuda_ms(lambda: tr.optimizer.update(
        grads, state["opt_state"], leaves), 2)
    launches = dict(zip(("K1", "K2", "K3"), _launch_counts()))
    per_image = vit_train_flops_per_image(cfg)
    out = {"model": "vit_b16", "params_m": cfg.num_params() / 1e6,
           "image_size": cfg.image_size, "patch": cfg.patch_size,
           "layers": cfg.num_layers, "hidden": cfg.hidden_size,
           "heads": cfg.num_heads, "mlp": cfg.mlp_dim,
           "classes": cfg.num_classes, "depth_cut": False, "batch": batch,
           "remat": "whole layer (the reference's)",
           "step_ms": 1e3 * step_s, "images_per_s": batch / step_s,
           "gflops_per_image": per_image / 1e9,
           "train_flops_per_step": per_image * batch,
           "mfu": per_image * batch / step_s / PEAK_FLOPS["bfloat16"],
           "peak_memory_gb": peak_gb, "init_s": init_s,
           "warmup_steps": warmup, "timed_steps": steps,
           "launches": launches, "losses": losses,
           "grad_norms": grad_norms, **streams,
           **idle_share(streams, 1e3 * step_s),
           "device_ms_by_class": device_ms_by_class(by_name),
           "optimizer_ms": optimizer_ms, "top_kernels_ms": top}
    if launches != {"K1": 0, "K2": 0, "K3": 0}:
        raise AssertionError(f"vit_train: K1/K2/K3 launched {launches} "
                             "times with the attention pinned to 'ref'")
    if not all(math.isfinite(x) for x in losses + grad_norms):
        raise AssertionError(f"vit_train: losses {losses}, grad norms "
                             f"{grad_norms}")
    return out


def vit_data_blocks(cfg, batch, batches, seed=4):
    """``batches`` blocks of ``batch`` uint8 images ``[b, H, W, C]`` and
    int64 labels, from numpy's generator seeded ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shape = (batch, cfg.image_size, cfg.image_size, cfg.num_channels)
    return [{"images": rng.integers(0, 256, shape, dtype=np.uint8),
             "labels": rng.integers(0, cfg.num_classes, batch,
                                    dtype=np.int64)}
            for _ in range(batches)]


def phase_data_vit(vit_run, device="cuda", batch=VIT_BATCH,
                   batches=DATA_VIT_BATCHES, warmup=DATA_VIT_WARMUP):
    """``vit_train``'s step (ViT-B/16, seed 0, the same optimizer) fed by
    ``iter_torch_batches(dtypes={"images": torch.float32},
    prefetch_batches=2)`` over ``from_blocks`` of ``vit_data_blocks``
    (one block per batch), in this process: ``warmup`` steps, then the
    rest chained and ended by one ``synchronize()``, as ``vit_train``
    times its steps.  Every landed batch is held, then compared bit for
    bit with ``torch.from_numpy(host).to(device, torch.float32)`` (the
    labels with their host rows); every loss must be finite and K1, K2
    and K3 must not launch.  The last warm-up step, its batch's fetch
    included, runs under the profiler, which records the pinned copies
    the stager makes meanwhile from its own thread.  Prints images/s and
    step ms beside ``vit_train``'s, how long each step waited for its
    batch, the host cast, the H2D copies' device ms and rate per batch
    (from that trace), each of the cast and the copy alone with the card
    idle, the page-locked bytes and peak memory (with the held
    batches)."""
    import numpy as np
    import torch

    import ray_tpu_torch.data as td
    from ray_tpu_torch.models.training import default_optimizer
    from ray_tpu_torch.models.vit import ViTConfig, make_vit_trainer

    cfg = ViTConfig.vit_b16()
    t0 = time.perf_counter()
    blocks = vit_data_blocks(cfg, batch, batches)
    make_s = time.perf_counter() - t0
    tr = make_vit_trainer(cfg, optimizer=default_optimizer(
        warmup=1, decay_steps=1000), device=device)
    state = tr.init_state(seed=0)
    it = td.from_blocks(blocks).iterator()
    feed = it.iter_torch_batches(batch_size=batch,
                                 dtypes={"images": torch.float32},
                                 device=device, prefetch_batches=2)
    landed, losses, blocked_ms = [], [], []

    def step():
        nonlocal state
        t0 = time.perf_counter()
        b = next(feed)
        blocked_ms.append(1e3 * (time.perf_counter() - t0))
        state, m = tr.step(state, b)
        losses.append(m["loss"])
        landed.append(b)

    _zero_launches()
    for _ in range(warmup - 1):
        step()
    _, streams = device_profile(step, copies=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(batches - warmup):
        step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (batches - warmup)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if next(feed, None) is not None:
        raise AssertionError("data_vit: the feed has more batches than "
                             "its dataset")
    stats = it.ingest_stats.to_dict()
    equal = [torch.equal(b["images"], torch.from_numpy(h["images"]).to(
        device, torch.float32)) and torch.equal(
        b["labels"], torch.from_numpy(h["labels"]).to(device))
        for b, h in zip(landed, blocks)]
    launches = dict(zip(("K1", "K2", "K3"), _launch_counts()))
    losses = [float(x) for x in losses]
    n = max(1, stats["h2d_batches"])
    alone = {"host_cast_alone_ms": "not measured",
             "h2d_copy_alone_ms": "not measured"}
    if torch.device(device).type == "cuda":
        # each host-side cost alone, the card idle: one batch's cast into
        # a page-locked buffer on this thread, and that buffer's copy
        pinned = torch.empty(landed[0]["images"].shape, dtype=torch.float32,
                             pin_memory=True)
        t0 = time.perf_counter()
        for h in blocks[:3]:
            np.copyto(pinned.numpy(), h["images"], casting="unsafe")
        alone["host_cast_alone_ms"] = 1e3 * (time.perf_counter() - t0) / 3
        dst = torch.empty_like(landed[0]["images"])
        alone["h2d_copy_alone_ms"] = cuda_ms(
            lambda: dst.copy_(pinned, non_blocking=True), 5)
        alone["h2d_copy_alone_gb_per_s"] = pinned.nbytes / alone[
            "h2d_copy_alone_ms"] / 1e6
    out = {"model": "vit_b16", "batch": batch, "batches": batches,
           "warmup_steps": warmup, "timed_steps": batches - warmup,
           "dataset": {"images": [batch, cfg.image_size, cfg.image_size,
                                  cfg.num_channels], "images_dtype": "uint8",
                       "labels_dtype": "int64", "blocks": batches,
                       "host_mb_per_batch": blocks[0]["images"].nbytes / 1e6,
                       "landed_mb_per_batch": blocks[0]["images"].size * 4
                       / 1e6, "make_s": make_s},
           "step_ms": 1e3 * step_s, "images_per_s": batch / step_s,
           "vit_train_step_ms": vit_run["step_ms"],
           "vit_train_images_per_s": vit_run["images_per_s"],
           "step_ms_minus_vit_train": 1e3 * step_s - vit_run["step_ms"],
           "consumer_blocked_ms_per_step": blocked_ms[warmup:],
           "consumer_blocked_ms_warmup": blocked_ms[:warmup],
           "host_cast_ms_per_batch": 1e3 * stats["host_cast_s"]
           / max(1, stats["batches"]),
           "h2d_host_ms_per_batch": 1e3 * stats["h2d_s"]
           / max(1, stats["batches"]),
           **h2d_from_trace(streams, len(blocks[0]), stats["h2d_bytes"] / n),
           "h2d_bytes_per_batch": stats["h2d_bytes"] / n, **alone,
           "pinned_bytes": stats["pinned_bytes"],
           "peak_memory_gb": peak_gb,
           "held_batches_gb": sum(t.numel() * t.element_size()
                                  for b in landed for t in b.values()) / 1e9,
           "ingest_stats": {k: v for k, v in stats.items() if k != "iterator"},
           "launches": launches, "losses": losses,
           "landed_equal_host_cast": equal}
    if not (len(equal) == batches and all(equal)):
        raise AssertionError(f"data_vit: landed batches equal to the host "
                             f"cast: {equal}")
    if launches != {"K1": 0, "K2": 0, "K3": 0}:
        raise AssertionError(f"data_vit: K1/K2/K3 launched {launches} "
                             "times with the attention pinned to 'ref'")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"data_vit: losses {losses}")
    return out


def health_probe_check():
    """In a process bound to ``cuda:0`` (``run_bound``): the health
    probe's payload, then ``device_memory_stats()`` with 1 GiB allocated
    on the card."""
    import torch

    from ray_tpu_torch._private.health_plane import _probe_payload
    from ray_tpu_torch.util.health import device_memory_stats

    probe = _probe_payload()
    block = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    rows = device_memory_stats()
    del block
    return {"probe": probe, "memory_rows": rows,
            "cards": torch.cuda.device_count()}


def _health_marker(side_dir, name, info):
    path = os.path.join(side_dir, name)
    with open(path + ".tmp", "w") as f:
        json.dump(info, f)
    os.replace(path + ".tmp", path)


def health_loop(config):
    """The reference's end-to-end loop (``tests/test_health.py:665``) in
    one worker: ``step_s`` of compute behind the ``train.work`` fault
    site, then a file barrier over the world standing in for the
    collective, its wait booked to ``collective_wait``; the step ledger
    publishes every step, and every step reports a checkpoint.  On a card
    (``config["matmuls"]``) the compute is that many bf16 matmuls of
    ``config["n"]`` square and the barrier a supervised NCCL allreduce,
    its device wait booked to ``collective_wait`` after the op's own.
    Checkpoints go beside ``config["side_dir"]``."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.util import collective as col
    from ray_tpu_torch.util.fault_injection import fault_point

    torch.set_num_threads(1)
    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    ledger = ctx.step_ledger()
    ledger._PUBLISH_EVERY_S = 0.0  # publish at every step boundary
    start = 0
    ck = ctx.get_checkpoint()
    if ck is not None:
        with open(os.path.join(ck.path, "state.json")) as f:
            start = json.load(f)["step"] + 1
    gpu = config.get("matmuls")
    if gpu:
        dev = ctx.get_device()
        gen = torch.Generator(device=dev).manual_seed(rank)
        a, b = (torch.randn(config["n"], config["n"], generator=gen,
                            device=dev, dtype=torch.bfloat16)
                for _ in range(2))
        x = torch.ones(1 << 20, device=dev)
        group = ctx.collective_group("nccl")
    for step in range(start, config["steps"]):
        with ledger.step():
            with ledger.bucket("compute"):
                fault_point("train.work")  # the degradable compute path
                if gpu:
                    for _ in range(config["matmuls"]):
                        a @ b
                    torch.cuda.synchronize()
                else:
                    time.sleep(config["step_s"])
            _health_marker(config["side_dir"], f"s{step}-w{world}-r{rank}",
                           {"step": step, "rank": rank, "world": world,
                            "node": ctx.get_node_id(), "t": time.time()})
            t0 = time.monotonic()
            if gpu:
                col.allreduce(x, group)
                t0 = time.monotonic()
                torch.cuda.synchronize()
            else:
                want = {f"s{step}-w{world}-r{r}" for r in range(world)}
                while time.monotonic() - t0 < 60:
                    if want <= set(os.listdir(config["side_dir"])):
                        break
                    time.sleep(0.01)
            ledger.note("collective_wait", time.monotonic() - t0)
        ckpt = os.path.join(os.path.dirname(config["side_dir"]), "ckpt",
                            f"w{world}-r{rank}-s{step}")
        os.makedirs(ckpt)
        with open(os.path.join(ckpt, "state.json"), "w") as f:
            json.dump({"step": step}, f)
        train.report({"step": step, "world": world,
                      "node": ctx.get_node_id()},
                     checkpoint=train.Checkpoint(ckpt))


def health_run(workers, use_gpu, victim_rank, config, min_workers,
               probe_timeout_s):
    """The health plane's loop end to end: ``health_loop`` over
    ``workers`` workers under ``ElasticScalingPolicy(min_workers,
    workers)`` and ``FailureConfig(max_failures=0)``, a ``HealthMonitor``
    on the run (interval 0.5 s, 2 windows, probe factor 1.5), and
    ``slow:3`` armed on the unit of rank ``victim_rank`` (``train.work``
    and ``health.probe``) once that rank has finished step 2.  Fails
    unless the run finishes every step, the unit is quarantined, and the
    group after the drain runs at ``workers - 1`` ranks off it.  Returns
    the monitor's summary, detection-to-quarantine and
    degradation-to-recovery seconds, and every probe's result."""
    import shutil
    import tempfile
    import threading

    from ray_tpu_torch._private.health_plane import HealthMonitor, node_health
    from ray_tpu_torch._private.node_faults import arm_node_fault
    from ray_tpu_torch.train import (ElasticScalingPolicy, FailureConfig,
                                     RunConfig, ScalingConfig, TorchTrainer)

    tmp = tempfile.mkdtemp(prefix="health_")
    side = os.path.join(tmp, "side")
    os.makedirs(side)
    trainer = TorchTrainer(
        health_loop, train_loop_config={"side_dir": side, **config},
        scaling_config=ScalingConfig(num_workers=workers, use_gpu=use_gpu),
        run_config=RunConfig(name="health-run", storage_path=tmp,
                             failure_config=FailureConfig(max_failures=0)),
        scaling_policy=ElasticScalingPolicy(min_workers, workers))
    armed = {}

    def saboteur():
        marker = os.path.join(side, f"s2-w{workers}-r{victim_rank}")
        deadline = time.time() + 300
        while time.time() < deadline and "node" not in armed:
            if os.path.exists(marker) and trainer.controller is not None:
                with open(marker) as f:
                    node = json.load(f)["node"]
                acks = [arm_node_fault(trainer.controller.kv, node, site,
                                       duration_s=600.0, exc="slow:3",
                                       timeout=10)["armed"]
                        for site in ("train.work", "health.probe")]
                armed.update(node=node, t=time.time(), acks=acks)
            time.sleep(0.05)

    mon = HealthMonitor(trainer=trainer, interval_s=0.5, suspect_windows=2,
                        probe_factor=1.5, probe_timeout_s=probe_timeout_s)
    mon.start()
    thread = threading.Thread(target=saboteur, daemon=True)
    thread.start()
    t0 = time.perf_counter()
    try:
        result = trainer.fit()
    finally:
        mon.stop()
        thread.join(timeout=5)
    fit_s = time.perf_counter() - t0
    try:
        markers = {}
        for name in os.listdir(side):
            if not name.endswith(".tmp"):
                with open(os.path.join(side, name)) as f:
                    markers[name] = json.load(f)
        ladder = node_health(trainer.controller.kv)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary = mon.summary()
    after = [m for n, m in markers.items() if f"-w{workers - 1}-" in n]
    steps = [m["step"] for m in result.metrics_history]
    out = {"workers": workers, "use_gpu": use_gpu, "fit_s": fit_s,
           "armed": armed, "quarantined": summary["quarantined"],
           "detection_to_quarantine_s":
               summary.get("detection_to_quarantine_s"),
           "degradation_to_recovery_s": (min(m["t"] for m in after)
                                         - armed["t"]) if after and armed
           else None,
           "nodes_after_drain": sorted({m["node"] for m in after}),
           "drain_restarts": trainer.controller.drain_restarts,
           "failures_charged": trainer.controller._ctx.errors_seen,
           "ladder": {n: r["health"] for n, r in ladder.items()},
           "counts": summary["counts"], "probes": mon.probes,
           "events": [{k: v for k, v in e.items() if k != "t"}
                      for e in summary["events"]],
           "last_step": steps[-1] if steps else None}
    if not (result.error is None and armed and steps
            and steps[-1] == config["steps"] - 1
            and armed["node"] in summary["quarantined"]
            and ladder.get(armed["node"], {}).get("health") == "QUARANTINED"
            and after and armed["node"] not in out["nodes_after_drain"]
            and len(out["nodes_after_drain"]) == workers - 1
            and out["failures_charged"] == 0):
        raise AssertionError(f"health run on {workers} "
                             f"{'cards' if use_gpu else 'host slots'}: "
                             f"error {result.error}, {out}")
    return out


def phase_health():
    """(a) ``_probe_payload`` in a process bound to ``cuda:0``: its digest
    must equal the host's ``sdc_digest(seed=7)``; with one card it pings
    nothing (with more, every landed tensor of its ring ping must be
    bit-equal); ``device_memory_stats()`` there with 1 GiB allocated must
    give ``cuda:0``'s row with at least 1 GiB in use.  (b) ``health_run``
    over three host workers (the reference's loop, 0.2 s steps)."""
    import torch

    from ray_tpu_torch._private.health_plane import run_bound
    from ray_tpu_torch.util.health import sdc_digest

    t0 = time.perf_counter()
    got = run_bound("cuda:0", health_probe_check, timeout=120)
    bound_s = time.perf_counter() - t0
    if got is None:
        raise AssertionError("health: the probe bound to cuda:0 did not "
                             "answer in 120 s")
    probe, rows = got["probe"], got["memory_rows"]
    row = next((r for r in rows if r["device"] == "cuda:0"), {})
    cards = torch.cuda.device_count()
    pinged = "ppermute_s" in probe
    ok = (probe["digest"] == sdc_digest(seed=7)
          and probe["node_id"] == "cuda:0"
          and row.get("bytes_in_use", 0) >= 1 << 30
          and (not pinged if cards == 1 else
               probe["ping_bit_equal"] and probe["ping_k4_launches"]
               == probe["ping_hops"] == cards))
    probe_out = {"bound_call_s": bound_s, "cards": cards,
                 "digest_equal_host": probe["digest"] == sdc_digest(seed=7),
                 "elapsed_s": probe["elapsed_s"], "pinged": pinged,
                 **{k: probe[k] for k in ("ppermute_s", "ping_hops",
                                          "ping_k4_launches",
                                          "ping_bit_equal") if k in probe},
                 "memory_row": row}
    if not ok:
        raise AssertionError(f"health: the bound probe {got}")
    run = health_run(3, False, 1, {"steps": HEALTH_STEPS,
                                   "step_s": HEALTH_STEP_S},
                     min_workers=2, probe_timeout_s=30.0)
    return {"probe_cuda0": probe_out, "host_slots": run}


def phase_health4():
    """``health_run`` over four workers, one card each: each step
    ``HEALTH4_MATMULS`` bf16 matmuls of ``HEALTH4_N`` square under
    ``train.work``, then a supervised NCCL allreduce; ``slow:3`` armed on
    card 2.  The monitor must confirm card 2 by the probe ratio and
    quarantine it, and the run must re-mesh onto cards 0, 1 and 3 under
    ``ElasticScalingPolicy(3, 4)``.  Every probe process sees the four
    cards and pings them: K4 must launch once per hop (four per probe)
    and every landed tensor must be bit-equal."""
    memory_before_spawn("health4")
    run = health_run(MESH4_RANKS, True, 2, {"steps": HEALTH4_STEPS,
                                            "matmuls": HEALTH4_MATMULS,
                                            "n": HEALTH4_N},
                     min_workers=MESH4_RANKS - 1, probe_timeout_s=120.0)
    probes = run["probes"]
    per_probe = [p.get("ping_k4_launches") for p in probes]
    run["k4_launches_per_probe"] = per_probe
    run["ping_bit_equal"] = all(p.get("ping_bit_equal") for p in probes)
    if run["armed"]["node"] != "cuda:2" or \
            run["nodes_after_drain"] != ["cuda:0", "cuda:1", "cuda:3"]:
        raise AssertionError(f"health4: armed {run['armed']}, the group "
                             f"after the drain on {run['nodes_after_drain']}")
    quarantine = [e for e in run["events"] if e["event"] == "quarantine"]
    if not (probes and per_probe == [MESH4_RANKS] * len(probes)
            and run["ping_bit_equal"]
            and "slower than reference" in quarantine[0]["reason"]):
        raise AssertionError(f"health4: probes {probes}, quarantine "
                             f"{quarantine}")
    return run


def serving_front(cfg, params, smi, names=SERVING_PHASES):
    """The serving front's phases named in ``names`` on ``params``
    (Llama-2-7B, bf16), each printing its line; ``llm_disagg`` runs
    ``llm_server`` first.  Returns their reports by name."""
    import torch

    head = {"model": "llama2_7b", "layers": cfg.num_layers,
            "depth_cut": False, "slots": SERVE_SLOTS,
            "max_len": SERVE_MAX_LEN, "block_size": SERVE_BLOCK}
    out = {}
    if names & {"llm_server", "llm_disagg"}:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["llm_server"] = phase_llm_server(cfg, params, smi)
        answers = {k: out["llm_server"].pop(k) for k in ("cold", "warm")}
        emit({"phase": "llm_server", **head, **out["llm_server"],
              "phase_s": time.perf_counter() - t0})
    if "llm_disagg" in names:
        t0 = time.perf_counter()
        out["llm_disagg"] = phase_llm_disagg(cfg, answers, smi)
        emit({"phase": "llm_disagg", **head, **out["llm_disagg"],
              "phase_s": time.perf_counter() - t0})
    if "llm_batch" in names:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["llm_batch"] = phase_llm_batch(cfg, params, smi)
        emit({"phase": "llm_batch", **head, **out["llm_batch"],
              "phase_s": time.perf_counter() - t0})
    return out


# ---------------------------------------------------------------------------
# the RL stack (``ray_tpu_torch.rl``): no kernel of K1-K4 on its paths; the
# rollouts and every learner update run as torch ops on the card
# ---------------------------------------------------------------------------

def rl_timed(fn):
    """``(fn(), wall ms)`` with the card synchronized on both sides."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def rl_profile(fn):
    """One call of ``fn`` under ``device_profile``: its wall ms, the
    card's busy ms (the union of kernel intervals) and idle share, the
    kernel count, the three longest kernels by name, and the launches of
    K1-K4 found by kernel name; "not measured" when there is no card (a
    rehearsal on the CPU)."""
    import torch

    if not torch.cuda.is_available():
        fn()
        return {"device_busy_ms": "not measured",
                "idle_share": "not measured",
                "k1_k4_launches_by_profiler": dict.fromkeys(
                    RL_PROFILER_NAMES, 0)}
    by_name, split = device_profile(fn, counts=True)
    if not split:
        raise AssertionError("the profiler recorded no device activity")
    launches = split["launches_by_name"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return {"call_ms": split["call_ms"],
            "device_busy_ms": split["device_busy_ms"],
            "idle_share": 1 - split["device_busy_ms"] / split["call_ms"],
            "kernels": sum(launches.values()),
            "top_kernels_ms": [[n[:60], ms] for n, ms in top],
            "k1_k4_launches_by_profiler": {
                k: sum(n_ for n, n_ in launches.items() if frag in n)
                for k, frag in RL_PROFILER_NAMES.items()}}


def rl_no_port_kernels(name, counted, profiled):
    """The RL paths run none of K1-K4: the wrappers' counts over the
    phase and the profiler's over its profiled call must both be 0."""
    if any(counted) or any(profiled["k1_k4_launches_by_profiler"].values()):
        raise AssertionError(f"{name}: K1-K4 launched on an RL path: "
                             f"{counted}, {profiled}")


def rl_max_err(a, b):
    """The largest |a - b| over two trees of tensors or arrays."""
    import numpy as np

    from ray_tpu_torch.rl.models import to_host, tree_leaves

    return max(float(np.max(np.abs(x - y)))
               for x, y in zip(tree_leaves(to_host(a)),
                               tree_leaves(to_host(b))))


def rl_ppo_check_inputs(algo):
    """The PPO check's inputs from ``algo`` (vectorized): a fresh
    fragment's batch, the two permutations its update would draw, and a
    GAE input of the fragment's shape: CartPole's reward 1, the batch's
    values (returns - advantages), dones drawn at 2% and the last row's
    values as the bootstrap."""
    import torch

    frag = algo.config.rollout_fragment_length
    _, _, batch, _ = algo._rollout(algo.learner.params, algo.env_state,
                                   algo.obs, algo.gen)
    n = batch["obs"].shape[0]
    perms = [torch.randperm(n, generator=algo.gen, device=algo.gen.device)
             for _ in range(algo.config.ppo.num_epochs)]
    values = (batch["returns"] - batch["advantages"]).reshape(frag, -1)
    dones = torch.rand(values.shape, generator=algo.gen,
                       device=algo.gen.device) < 0.02
    return batch, perms, (torch.ones_like(values), values, dones,
                          values[-1])


def rl_small_ppo_check(device="cuda"):
    """``rl_ppo``'s check at a small size: 64 envs x 16 steps, two
    iterations, then one update and GAE against the CPU."""
    from ray_tpu_torch.rl import PPO, AlgorithmConfig

    algo = (AlgorithmConfig(PPO, device=device).environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=64,
                         rollout_fragment_length=16)
            .training(num_epochs=2, num_minibatches=4).build())
    for _ in range(2):
        algo.train()
    return rl_ppo_vs_cpu(algo.learner, *rl_ppo_check_inputs(algo))


def rl_ppo_vs_cpu(learner, batch, perms, traj):
    """One ``PPOLearner._update_with_perms`` and one ``compute_gae`` on
    ``learner``'s device and on the CPU from the same parameters,
    optimizer state, batch and permutations (the trajectory ``traj``:
    rewards, values, dones, last_value): the largest differences, held to
    ``RL_PARAMS_ATOL`` and ``RL_GAE_ATOL``."""
    from ray_tpu_torch.rl import PPOLearner, compute_gae
    from ray_tpu_torch.rl.models import to_host

    cpu = PPOLearner(learner.module, learner.config, device="cpu")
    cpu.set_state(learner.get_state())
    host_batch = to_host(batch)
    host_perms = [p.cpu() for p in perms]
    learner._update_with_perms(batch, perms)
    cpu._update_with_perms(host_batch, host_perms)
    params_err = rl_max_err(learner.params, cpu.params)
    dev = compute_gae(*traj, 0.99, 0.95)
    host = compute_gae(*(t.cpu() for t in traj), 0.99, 0.95)
    gae_err = max(rl_max_err(d, h) for d, h in zip(dev, host))
    if not (params_err <= RL_PARAMS_ATOL and gae_err <= RL_GAE_ATOL):
        raise AssertionError(
            f"PPO on {learner.device} against the CPU: params off by "
            f"{params_err} (atol {RL_PARAMS_ATOL}), GAE by {gae_err} "
            f"(atol {RL_GAE_ATOL})")
    return {"update_params_max_abs_err": params_err,
            "gae_max_abs_err": gae_err, "params_atol": RL_PARAMS_ATOL,
            "gae_atol": RL_GAE_ATOL}


def rl_family_vs_cpu(name, obj, make_cpu, update):
    """One update of family ``name`` on ``obj``'s device and on a CPU twin
    (``make_cpu()`` loaded with ``obj``'s checkpoint), ``update(o)``
    running it on either from the same inputs; the trained and target
    trees after it are held to ``RL_PARAMS_ATOL``."""
    from ray_tpu_torch.rl.convert import TARGETS, TRAINED

    cpu = make_cpu()
    cpu.load_checkpoint(obj.save_checkpoint())
    update(obj)
    update(cpu)
    # IMPALA/APPO hold their trees in their learner
    held, twin = getattr(obj, "learner", obj), getattr(cpu, "learner", cpu)
    kind = next(c.__name__ for c in type(held).__mro__
                if c.__name__ in TRAINED)
    trees = TRAINED[kind] + TARGETS.get(kind, ())
    err = max(rl_max_err(getattr(held, t), getattr(twin, t))
              for t in trees)
    if not err <= RL_PARAMS_ATOL:
        raise AssertionError(f"{name} on {obj.device} against the CPU: "
                             f"{trees} off by {err} (atol {RL_PARAMS_ATOL})")
    return {"update_params_max_abs_err": err}


def rl_dreamer_vs_cpu(obj, make_cpu, seed=0):
    """The world-model loss of ``obj`` (a DreamerV3) on its device and on
    a CPU twin from one replay batch with the same latent noise, then one
    world-model update on both, held to ``RL_DREAMER_LOSS_RTOL`` and
    ``RL_PARAMS_ATOL``."""
    import torch

    from ray_tpu_torch.rl import dreamer as dm
    from ray_tpu_torch.rl.models import as_tensors, gumbel, to_host

    p = obj.p
    cpu = make_cpu()
    cpu.load_checkpoint(obj.save_checkpoint())
    batch = to_host(obj._sample_batch())
    gen = torch.Generator().manual_seed(seed)
    noise = gumbel((p.batch_length, p.batch_size, p.codes, p.classes),
                      gen)
    losses = []
    for o in (obj, cpu):
        total, _ = dm.wm_loss(o.wm, as_tensors(batch, o.device), p,
                              o.n_actions, noise=noise.to(o.device))
        losses.append(float(total.detach()))
        o._wm_update(as_tensors(batch, o.device), noise.to(o.device))
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    err = rl_max_err(obj.wm, cpu.wm)
    if not (rel <= RL_DREAMER_LOSS_RTOL and err <= RL_PARAMS_ATOL):
        raise AssertionError(
            f"DreamerV3 on {obj.device} against the CPU: world-model loss "
            f"{losses} (rtol {RL_DREAMER_LOSS_RTOL}), params off by {err}")
    return {"wm_loss": losses[0], "wm_loss_cpu": losses[1],
            "wm_loss_rel_err": rel, "update_params_max_abs_err": err}


class HostCartPole(_GymVectorEnv):
    """CartPole-v1 stepped in numpy on the host: a ``GymVectorEnv`` for
    the runner processes where gymnasium is absent (the card's machine
    has none).  gymnasium's physics (Euler steps in fp64, fp32
    observations, reward 1 per step, the 500-step limit) and the
    ``SAME_STEP`` autoreset contract of ``GymVectorEnv.step``: the step
    that ends an episode returns the reset observation and the final one
    apart."""

    def __init__(self, name="HostCartPole-v1"):
        import numpy as np

        self.name = name
        self.spec = _EnvSpec(obs_dim=4, num_actions=2, max_episode_steps=500)
        self.theta_threshold = 12 * 2 * np.pi / 360

    def make_batch(self, num_envs, seed=0):
        import numpy as np

        self.rng = np.random.default_rng(seed)
        self.state = self.rng.uniform(-0.05, 0.05, (num_envs, 4))
        self.steps = np.zeros(num_envs, np.int64)
        return self.state.astype(np.float32)

    def step(self, actions):
        import numpy as np

        x, x_dot, theta, theta_dot = self.state.T
        force = np.where(actions == 1, 10.0, -10.0)
        cos, sin = np.cos(theta), np.sin(theta)
        temp = (force + 0.05 * theta_dot ** 2 * sin) / 1.1
        thetaacc = (9.8 * sin - cos * temp) / (
            0.5 * (4.0 / 3.0 - 0.1 * cos ** 2 / 1.1))
        xacc = temp - 0.05 * thetaacc * cos / 1.1
        x, x_dot = x + 0.02 * x_dot, x_dot + 0.02 * xacc
        theta, theta_dot = theta + 0.02 * theta_dot, theta_dot + 0.02 * thetaacc
        final = np.stack([x, x_dot, theta, theta_dot], 1)
        self.steps += 1
        term = (np.abs(x) > 2.4) | (np.abs(theta) > self.theta_threshold)
        trunc = (self.steps >= self.spec.max_episode_steps) & ~term
        done = term | trunc
        fresh = self.rng.uniform(-0.05, 0.05, final.shape)
        self.state = np.where(done[:, None], fresh, final)
        self.steps[done] = 0
        return (self.state.astype(np.float32),
                np.ones(len(actions), np.float32), term, trunc,
                final.astype(np.float32))


def rl_runner_env():
    """The env the runner processes step: gymnasium's CartPole-v1 where
    gymnasium imports, else ``HostCartPole`` registered as
    ``HostCartPole-v1`` (the runners get the factory from the group)."""
    from ray_tpu_torch.rl import register_env

    try:
        import gymnasium  # noqa: F401
        return "CartPole-v1", "gymnasium CartPole-v1"
    except ImportError:
        register_env("HostCartPole-v1", HostCartPole)
        return "HostCartPole-v1", ("chip_smoke.HostCartPole (numpy, "
                                   "gymnasium absent)")


def rl_learning(rewards):
    """The reference's learning check (``tests/test_rl.py:89-92``): late
    (the last three) > 1.5 x early (the first two) and late > 40."""
    import numpy as np

    early, late = float(np.mean(rewards[:2])), float(np.mean(rewards[-3:]))
    return early, late, bool(late > 1.5 * early and late > 40)


def phase_rl_ppo(device="cuda", num_envs=RL_PPO_ENVS, frag=RL_FRAGMENT,
                 iters=RL_PPO_ITERS):
    """The vectorized mode of ``benchmarks/rl_ppo_bench.py`` through
    ``AlgorithmConfig(PPO)``: CartPole-v1 on the card, ``num_envs`` x
    ``frag`` steps per iteration, hidden (64, 64), lr 3e-4, 2 epochs x 4
    minibatches.  Every iteration's wall and episode reward; then one
    iteration's rollout and update apart, one iteration profiled, and
    one update and GAE against the CPU."""
    import numpy as np
    import torch

    from ray_tpu_torch.rl import PPO, AlgorithmConfig

    algo = (AlgorithmConfig(PPO, device=device).environment("CartPole-v1")
            .env_runners(num_env_runners=0,
                         num_envs_per_env_runner=num_envs,
                         rollout_fragment_length=frag)
            .training(lr=3e-4, num_epochs=2, num_minibatches=4).seed_(0)
            .build())
    _zero_launches()
    rewards, iter_ms, steps = [], [], 0
    for _ in range(iters):
        m, ms = rl_timed(algo.train)
        rewards.append(m["episode_reward_mean"])
        iter_ms.append(ms)
        steps = m["env_steps_this_iter"]
    counted = list(_all_launches())
    early, late, learned = rl_learning(rewards)
    split = {"rollout_ms": [], "update_ms": []}
    for _ in range(3):
        out, ms = rl_timed(lambda: algo._rollout(
            algo.learner.params, algo.env_state, algo.obs, algo.gen))
        algo.env_state, algo.obs, batch, _ = out
        split["rollout_ms"].append(ms)
        _, ms = rl_timed(lambda: algo.learner.update(batch, algo.gen))
        split["update_ms"].append(ms)
    profiled = rl_profile(algo.train)
    vs_cpu = rl_ppo_vs_cpu(algo.learner, *rl_ppo_check_inputs(algo))
    timed = iter_ms[1:]
    out = {"env": "CartPole-v1 (torch, on the card)", "num_envs": num_envs,
           "fragment": frag, "iterations": iters, "hidden": [64, 64],
           "lr": 3e-4, "epochs": 2, "minibatches": 4,
           "env_steps_per_iter": steps,
           "env_steps_per_s": steps * len(timed) / (sum(timed) / 1e3),
           "ms_per_iter": float(np.median(timed)),
           "first_iter_ms": iter_ms[0],
           "rollout_ms": float(np.median(split["rollout_ms"])),
           "update_ms": float(np.median(split["update_ms"])),
           "profiled_iter": profiled, "reward_curve": rewards,
           "early": early, "late": late, "learned": learned,
           "k1_k4_launches": counted, "vs_cpu": vs_cpu,
           "tf32_matmul": torch.backends.cuda.matmul.allow_tf32}
    rl_no_port_kernels("rl_ppo", counted, profiled)
    if not learned:
        raise AssertionError(f"rl_ppo did not learn: early {early}, late "
                             f"{late} (late > 1.5 x early and > 40): "
                             f"{rewards}")
    return out


def phase_rl_runners(device="cuda", runners=RL_RUNNERS,
                     num_envs=RL_RUNNER_ENVS, frag=RL_FRAGMENT,
                     iters=RL_RUNNER_ITERS):
    """The distributed mode of the same bench: ``runners`` EnvRunner
    processes x ``num_envs`` envs x ``frag`` steps on the host, the
    learner on ``device``.  Between two iterations one runner's process
    is killed: the next iteration must finish with the group at full
    strength and ``respawns_left`` down by one."""
    import signal

    import numpy as np

    from ray_tpu_torch.rl import PPO, AlgorithmConfig

    env_name, env_desc = rl_runner_env()
    t0 = time.perf_counter()
    algo = (AlgorithmConfig(PPO, device=device).environment(env_name)
            .env_runners(num_env_runners=runners,
                         num_envs_per_env_runner=num_envs,
                         rollout_fragment_length=frag)
            .training(lr=3e-4, num_epochs=2, num_minibatches=4).seed_(0)
            .build())
    start_s = time.perf_counter() - t0
    group = algo.runner_group
    try:
        ran = group.env_names()
        _zero_launches()
        iter_ms, steps = [], 0
        for _ in range(iters):
            m, ms = rl_timed(algo.train)
            iter_ms.append(ms)
            steps = m["env_steps_this_iter"]
        samples, sample_ms = rl_timed(lambda: group.sample(frag))
        _, sync_ms = rl_timed(
            lambda: group.sync_weights(algo.learner.get_weights()))
        profiled = rl_profile(algo.train)
        counted = list(_all_launches())
        before, victim = group.respawns_left, group.pids()[0]
        os.kill(victim, signal.SIGKILL)
        m, kill_iter_ms = rl_timed(algo.train)
        after = group.respawns_left
        respawned = (after == before - 1 and victim not in group.pids()
                     and len(group.runners) == runners
                     and bool(np.isfinite(m["pi_loss"])))
        m2, _ = rl_timed(algo.train)
        out = {"env": env_desc, "runner_envs": sorted(set(ran)),
               "runners": runners, "envs_per_runner": num_envs,
               "fragment": frag, "learner_device": device,
               "runner_start_s": start_s,
               "env_steps_per_iter": steps,
               "env_steps_per_s": steps * len(iter_ms[1:])
               / (sum(iter_ms[1:]) / 1e3),
               "ms_per_iter": float(np.median(iter_ms[1:])),
               "sample_ms": sample_ms, "sample_fragments": len(samples),
               "sync_weights_ms": sync_ms, "profiled_iter": profiled,
               "k1_k4_launches": counted,
               "killed_pid": victim, "kill_iter_ms": kill_iter_ms,
               "kill_iter_env_steps": m["env_steps_this_iter"],
               "after_kill_env_steps": m2["env_steps_this_iter"],
               "respawns_left": [before, after], "respawned": respawned,
               "dropped": group.dropped_runners}
    finally:
        algo.stop()
    rl_no_port_kernels("rl_runners", counted, profiled)
    if not (respawned and out["after_kill_env_steps"]
            == runners * num_envs * frag):
        raise AssertionError(f"rl_runners: the killed runner was not "
                             f"respawned: {out}")
    return out


def phase_rl_multi_agent(device="cuda", num_envs=RL_MA_ENVS,
                         frag=RL_FRAGMENT, iters=RL_MA_ITERS):
    """``benchmarks/rl_ppo_bench.py``'s ``run_multi_agent``: PursuitTag
    (two agents, zero-sum) with independent PPO learners on ``device``,
    2 epochs x 4 minibatches; the reference's checks: the learners start
    equal and diverge, and the agents' rewards are opposite."""
    import numpy as np
    import torch

    from ray_tpu_torch.rl import MultiAgentPPO, PPOConfig, PursuitTagEnv
    from ray_tpu_torch.rl.models import tree_leaves

    ma = MultiAgentPPO(PursuitTagEnv(), num_envs=num_envs, rollout_len=frag,
                       config=PPOConfig(num_epochs=2, num_minibatches=4),
                       device=device)
    same_init = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(ma.learners["pursuer"].params),
        tree_leaves(ma.learners["evader"].params)))
    _zero_launches()
    iter_ms, env_steps, agent_steps, rewards = [], 0, 0, []
    for _ in range(iters):
        m, ms = rl_timed(ma.train)
        iter_ms.append(ms)
        env_steps, agent_steps = (m["env_steps_this_iter"],
                                  m["agent_steps_this_iter"])
        rewards.append([m["agent/pursuer/reward_per_step"],
                        m["agent/evader/reward_per_step"]])
    profiled = rl_profile(ma.train)
    counted = list(_all_launches())
    diverged = any(not torch.allclose(a, b) for a, b in zip(
        tree_leaves(ma.learners["pursuer"].params),
        tree_leaves(ma.learners["evader"].params)))
    zero_sum = all(abs(p + e) <= 1e-5 * max(1.0, abs(p))
                   for p, e in rewards)
    timed = iter_ms[1:]
    out = {"env": "PursuitTag (2-agent zero-sum, torch, on the card)",
           "agents": 2, "policies": len(ma.policy_ids),
           "num_envs": num_envs, "fragment": frag, "iterations": iters,
           "env_steps_per_s": env_steps * len(timed) / (sum(timed) / 1e3),
           "agent_steps_per_s": agent_steps * len(timed)
           / (sum(timed) / 1e3),
           "ms_per_iter": float(np.median(timed)),
           "first_iter_ms": iter_ms[0], "profiled_iter": profiled,
           "pursuer_reward_curve": [r[0] for r in rewards],
           "same_init": same_init, "diverged": diverged,
           "zero_sum": zero_sum, "k1_k4_launches": counted}
    rl_no_port_kernels("rl_multi_agent", counted, profiled)
    if not (same_init and diverged and zero_sum):
        raise AssertionError(f"rl_multi_agent: {out}")
    return out


def rl_offline_data(n=2048, seed=0):
    """The reference tests' offline data: obs from a seed, the good
    action ``obs[:, 0] > 0`` taken 90% of the time, reward 1 for it."""
    import numpy as np

    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(n, 4)).astype(np.float32)
    good = (obs[:, 0] > 0).astype(np.int32)
    actions = np.where(rng.random(n) < 0.9, good, 1 - good).astype(np.int32)
    return {"obs": obs, "actions": actions,
            "rewards": (actions == good).astype(np.float32),
            "returns": (actions == good).astype(np.float32)
            + rng.normal(size=n).astype(np.float32) * 0.1,
            "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
            "terminals": np.ones((n,), np.float32)}


def rl_family_cases(device, small=False):
    """Each family at its reference defaults on ``device`` (``small``: the
    card tests' sizes): ``(name, build(device), iterate(obj), update(obj)
    or None for Dreamer, losses(metrics))``."""
    import numpy as np

    from ray_tpu_torch.rl import (APPO, BC, CQL, IMPALA, MARWIL,
                                  AlgorithmConfig, DQNConfig,
                                  DreamerParams, DreamerV3, SACConfig)

    data = rl_offline_data(256 if small else 2048)
    steps = 128 if small else 512
    starts = dict(learning_starts=64) if small else {}
    rng = np.random.default_rng(1)

    def impala(cls):
        def build(dev):
            return (AlgorithmConfig(cls, device=dev)
                    .environment("CartPole-v1")
                    .env_runners(num_env_runners=0,
                                 num_envs_per_env_runner=8,
                                 rollout_fragment_length=32 if small
                                 else 128).build())
        return build

    def impala_update(o):
        o.learner.update(impala_batch)

    impala_batch = {}

    def impala_iter(o):
        nonlocal impala_batch
        _, _, batch, _ = o._rollout(o.learner.params, o.env_state, o.obs,
                                    o.gen)
        impala_batch = {k: v.cpu().numpy() for k, v in batch.items()}
        return o.train()

    replay = {}

    def replay_iter(o):
        m = o.train(steps_per_iteration=steps)
        replay[o.config.params.__class__.__name__] = o.buffer.sample(
            64, rng)
        return m

    def replay_update(o):
        o._update(replay[o.config.params.__class__.__name__])

    dreamer = (DreamerParams(batch_size=4, batch_length=8, horizon=5)
               if small else DreamerParams())
    return [
        ("dqn", lambda d: DQNConfig(device=d).environment("CartPole-v1")
         .training(**starts).build(), replay_iter, replay_update,
         ("loss",)),
        ("sac", lambda d: SACConfig(device=d).environment("CartPole-v1")
         .training(**starts).build(), replay_iter, replay_update,
         ("q_loss", "pi_loss")),
        ("impala", impala(IMPALA), impala_iter, impala_update,
         ("pi_loss", "vf_loss")),
        ("appo", impala(APPO), impala_iter, impala_update,
         ("pi_loss", "vf_loss")),
        ("cql", lambda d: CQL(4, 2, device=d),
         lambda o: o.train_on(data, batch_size=256),
         lambda o: o._update({k: data[k][:256] for k in CQL.REQUIRED}),
         ("td_loss", "cql_penalty")),
        ("bc", lambda d: BC(4, 2, device=d),
         lambda o: o.train_on(data, batch_size=256),
         lambda o: o._update({k: data[k][:256] for k in ("obs", "actions")}),
         ("pi_loss",)),
        ("marwil", lambda d: MARWIL(4, 2, device=d),
         lambda o: o.train_on(data, batch_size=256),
         lambda o: o._update({k: data[k][:256] for k in
                              ("obs", "actions", "returns")}),
         ("pi_loss", "vf_loss")),
        ("dreamer", lambda d: DreamerV3("CartPole-v1", dreamer, device=d),
         lambda o: o.train(64 if small else 256), None,
         ("wm_total", "actor_loss", "critic_loss")),
    ]


def rl_families(device="cuda", small=False, iters=RL_FAMILY_ITERS):
    """Each family of ``rl_family_cases``: ``iters`` iterations (ms each,
    losses finite), the update's ms, one iteration profiled, and one
    update on ``device`` against the CPU from the same inputs (Dreamer:
    the world-model loss and update with the same latent noise)."""
    import numpy as np

    out = {}
    for name, build, iterate, update, losses in rl_family_cases(device,
                                                                small):
        obj = build(device)
        _zero_launches()
        iter_ms, metrics = [], []
        for _ in range(iters):
            m, ms = rl_timed(lambda: iterate(obj))
            iter_ms.append(ms)
            metrics.append(m)
        counted = list(_all_launches())
        vals = {k: metrics[-1].get(k) for k in losses}
        finite = all(v is not None and bool(np.isfinite(v))
                     for v in vals.values())
        if update is None:
            batch = obj._sample_batch()
            aux, update_ms = rl_timed(lambda: obj._wm_update(batch))
            _, ac_ms = rl_timed(lambda: obj._ac_update(aux["hs"],
                                                       aux["zs"]))
            update_ms = {"world_model": update_ms, "actor_critic": ac_ms}
            profiled = rl_profile(lambda: iterate(obj))
            check = rl_dreamer_vs_cpu(obj, lambda: build("cpu"))
        else:
            update_ms = float(np.median([rl_timed(lambda: update(obj))[1]
                                         for _ in range(5)]))
            profiled = rl_profile(lambda: iterate(obj))
            check = rl_family_vs_cpu(name, obj, lambda: build("cpu"), update)
        out[name] = {"ms_per_iter": float(np.median(iter_ms)),
                     "first_iter_ms": iter_ms[0], "update_ms": update_ms,
                     "losses": vals, "finite": finite,
                     "profiled_iter": profiled, "vs_cpu": check,
                     "k1_k4_launches": counted}
        rl_no_port_kernels(f"rl_families {name}", counted, profiled)
        if not finite:
            raise AssertionError(f"rl_families {name}: losses {vals} after "
                                 f"{iters} iterations")
        if hasattr(obj, "stop"):
            obj.stop()
    return out


def phase_rl_families(device="cuda"):
    return {"families": rl_families(device), "iterations": RL_FAMILY_ITERS,
            "params_atol": RL_PARAMS_ATOL,
            "dreamer_loss_rtol": RL_DREAMER_LOSS_RTOL}


def rl_phases(smi, names=RL_PHASES):
    """The RL phases named in ``names``, each printing its line with the
    card's name and power limit; returns their reports by name."""
    import torch

    out = {}
    for name, phase in (("rl_ppo", phase_rl_ppo),
                        ("rl_runners", phase_rl_runners),
                        ("rl_multi_agent", phase_rl_multi_agent),
                        ("rl_families", phase_rl_families)):
        if name not in names:
            continue
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out[name] = phase()
        emit({"phase": name, "card": smi, **out[name],
              "phase_s": time.perf_counter() - t0})
    return out


def rl_launches_by_path(rl, i):
    """Kernel ``i``'s (K1-K4) launches on each RL path, by the profiler
    over its profiled iteration (0: the RL paths run none of them)."""
    key = ("K1", "K2", "K3", "K4")[i]
    out = {name: rl[name]["profiled_iter"]["k1_k4_launches_by_profiler"][key]
           for name in ("rl_ppo", "rl_runners", "rl_multi_agent")}
    out["rl_families"] = sum(
        f["profiled_iter"]["k1_k4_launches_by_profiler"][key]
        for f in rl["rl_families"]["families"].values())
    return out


# ---------------------------------------------------------------------------
# the RLHF loop, weight sync and the tiered checkpoint plane
# ---------------------------------------------------------------------------


def host_leaf_sha256(tree):
    """``{path: sha256 hex}`` of every tensor leaf of a tree on the host
    (on a pool of threads; a CUDA leaf is copied to the host first)."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from ray_tpu_torch.rl.weight_sync import _leaf_bytes
    from ray_tpu_torch.train.checkpoint_async import leaf_paths

    _, paths, values = leaf_paths(tree)
    leaves = [(p, x) for p, x in zip(paths, values)
              if isinstance(x, torch.Tensor)]
    with ThreadPoolExecutor(8) as ex:
        digests = list(ex.map(
            lambda px: hashlib.sha256(_leaf_bytes(px[1])[2]).hexdigest(),
            leaves))
    return {p: d for (p, _), d in zip(leaves, digests)}


def blob_leaf_sha256(blob):
    """``{path: sha256 hex}`` of every tensor piece of a sole writer's
    shard blob, read in place (the snapshot as it was saved)."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    from ray_tpu_torch.train import checkpoint_async as ca

    regions = [(path, data) for path, _b, kind, _d, _s, data
               in ca.blob_pieces(blob) if kind == "torch"]
    with ThreadPoolExecutor(8) as ex:
        digests = list(ex.map(lambda r: hashlib.sha256(r[1]).hexdigest(),
                              regions))
    return {p: d for (p, _), d in zip(regions, digests)}


def rlhf_update_check(device="cuda"):
    """One RLHF learner update (REINFORCE, Adam at the loop's lr) on
    ``device`` against the same update on the CPU, from the same params
    (the module's init from seed 0) and batch (seed 1, the scripted
    reward)."""
    import numpy as np
    import torch

    from ray_tpu_torch.rl import rlhf
    from ray_tpu_torch.rl.models import ActorCriticModule, to_device

    cfg = rlhf.RLHFConfig()
    mod = ActorCriticModule(cfg.obs_dim, cfg.vocab_size, cfg.hidden)
    base = mod.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    obs = rng.standard_normal((64, cfg.obs_dim)).astype(np.float32)
    actions = rng.integers(0, cfg.vocab_size, 64).astype(np.int32)
    batch = {"obs": obs, "actions": actions,
             "rewards": rlhf.scripted_reward(obs, actions, cfg)}
    out = {}
    for dev in ("cpu", device):
        params = to_device(base, torch.device(dev), requires_grad=True)
        tx, update = rlhf._make_update_fn(mod, cfg.lr)
        params, _, loss = update(params, tx.init(params), {
            k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        out[dev] = (float(loss), {f"{t}.{k}": v.detach().cpu()
                                  for t in params
                                  for k, v in params[t].items()})
    loss_diff = abs(out["cpu"][0] - out[device][0])
    params_diff = max(float((out["cpu"][1][k] - v).abs().max())
                      for k, v in out[device][1].items())
    if not (loss_diff <= RLHF_LOSS_ATOL and params_diff <= RLHF_PARAMS_ATOL):
        raise AssertionError(
            f"rlhf: the learner update on {device} differs from the CPU's: "
            f"loss by {loss_diff} (atol {RLHF_LOSS_ATOL}), params by "
            f"{params_diff} (atol {RLHF_PARAMS_ATOL})")
    return {"loss_abs_diff": loss_diff, "params_max_abs_diff": params_diff,
            "loss_atol": RLHF_LOSS_ATOL, "params_atol": RLHF_PARAMS_ATOL}


def rlhf_worker_loop(config):
    """The RLHF worker's loop (``rlhf._rlhf_train_loop``) between K1-K4's
    counts zeroed and read in the worker, reported as a last row with the
    processes the worker started (its rollout processes)."""
    t_start = time.time()
    from ray_tpu_torch import train
    from ray_tpu_torch._private import worker_zygote
    from ray_tpu_torch.rl import rlhf

    _zero_launches()
    rlhf._rlhf_train_loop(config)
    train.report({"kind": "launches", "k1_k2_k3_k4": list(_all_launches()),
                  "t_loop_start": t_start,
                  "worker_starts": worker_zygote.stats()})


def phase_rlhf(device=None):
    """``RLHFLoop`` with the reference's end-to-end configuration
    (``tests/test_rlhf.py:217-229``), the learner on the card; the
    worker's loop is wrapped only to count K1-K4 there.  Fails unless the
    reference test's checks hold and one update on the card matches the
    CPU's."""
    import numpy as np

    from ray_tpu_torch.rl import RLHFConfig, RLHFLoop, rlhf

    t0 = time.perf_counter()
    check = rlhf_update_check(device or "cuda")
    cfg = RLHFConfig(device=device,
        iterations=4, num_rollout_actors=2, rollout_batch=32,
        learner_batch_size=32, name="rlhf-e2e", mesh="dp",
        sample_timeout_s=60.0, verify_weights_on_read=True,
        chaos={"kill_rollout_at_iter": 2, "publish_fault_at": 2,
               "reward_fault_at": 3})
    memory_before_spawn("rlhf")
    loop_fn = rlhf._rlhf_train_loop
    rlhf._rlhf_train_loop = rlhf_worker_loop  # travels by reference
    t_fit = time.time()
    try:
        result = RLHFLoop(cfg).run()
    finally:
        rlhf._rlhf_train_loop = loop_fn
    fit_s = time.time() - t_fit
    if result.error is not None:
        raise AssertionError(f"rlhf: {result.error}")
    rows = result.metrics_history
    counted = rows.pop()
    m = rows[-1]
    cv = m["consumed_versions"]
    problems = [name for name, ok in (
        ("4 iterations", m["training_iteration"] == 4),
        ("publish fault fired", m["publish_faults_fired"] >= 1),
        ("reward fault fired", m["reward_faults_fired"] >= 1),
        ("a respawn", m["respawns_used"] >= 1),
        ("a dropped batch", m["trajectories_dropped"] >= 1),
        ("no duplicate", m["duplicates_rejected"] == 0),
        ("consumed <= produced",
         m["trajectories_consumed"] <= m["trajectories_produced"]),
        ("consumed versions non-decreasing",
         len(cv) >= 3 and all(a <= b for a, b in zip(cv, cv[1:]))),
        ("version 5 at epoch 0",
         m["published_version"] == 5 and m["publisher_epoch"] == 0),
        ("rows consumed", m["rows_consumed"] > 0),
        ("finite loss", bool(np.isfinite(m["loss"]))),
        ("no rejected payload",
         all(s["rejected"] == 0 for s in m["subscriber_stats"])),
        ("K1-K4 0 in the worker", counted["k1_k2_k3_k4"] == [0] * 4),
        ("rollouts forked by the zygote",
         counted["worker_starts"]["children"] >= 3
         and not counted["worker_starts"]["fallbacks"]
         and not counted["worker_starts"]["restarts"]
         and not counted["worker_starts"]["cold"]))
        if not ok]
    if problems:
        raise AssertionError(f"rlhf: failed {problems}: {m}")
    return {
        "model": "ActorCriticModule (obs 8, vocab 8, hidden 32x32)",
        "learner": f"{device or 'cuda'} in one TorchTrainer worker",
        "update_vs_cpu": check,
        "iterations": [{"iteration": r["training_iteration"],
                        "wall_s": r["iteration_walls_s"][-1],
                        **r["iteration_split_s"],
                        "loss": r["loss"], "mean_reward": r["mean_reward"],
                        "published_version": r["published_version"],
                        "last_publish": r["last_publish"]}
                       for r in rows],
        "publisher": {k: v for k, v in m.items()
                      if k.startswith("publisher_")},
        "subscribers": m["subscriber_stats"],
        "ledger": {k: m[k] for k in (
            "trajectories_produced", "trajectories_consumed",
            "trajectories_dropped", "duplicates_rejected")},
        "faults": {k: m[k] for k in ("publish_faults_fired",
                                     "reward_faults_fired",
                                     "respawns_used")},
        "consumed_versions": cv,
        "worker_start_s": counted["t_loop_start"] - t_fit,
        "loop_setup_s": m["setup_s"],
        "rollout_startup_s": m["rollout_startup_s"],
        "worker_starts": counted["worker_starts"],
        "k1_k2_k3_k4_launches": counted["k1_k2_k3_k4"],
        "fit_s": fit_s, "phase_s": time.perf_counter() - t0}


def ws7b_subscriber(conn, kv_addr):
    """The weight_sync_7b subscriber: a CPU process that adopts each
    version it is told of, verifies it against its digest, and answers
    with its leaves' sha256 and its fetch and verify times."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    t0 = time.perf_counter()
    from ray_tpu_torch._private import kv as kv_mod

    os.environ[kv_mod.ENV_KV] = kv_addr
    from ray_tpu_torch.rl.weight_sync import WeightSubscriber, params_digest

    sub = WeightSubscriber("ws7b", verify_on_read=True, device="cpu")
    conn.send({"ready_s": time.perf_counter() - t0})
    while True:
        msg = conn.recv()
        if msg[0] == "stop":
            break
        want = msg[1]
        deadline = time.monotonic() + 300
        while (sub.version is None or sub.version.version < want) and \
                time.monotonic() < deadline:
            sub.poll(timeout_s=1.0)
        t1 = time.perf_counter()
        params, ver = sub.current()  # verify_on_read: hashed again
        verify_read_s = time.perf_counter() - t1
        conn.send({"version": ver.version, "epoch": ver.epoch,
                   "digest": params_digest(params, ver.version, ver.epoch),
                   "leaf_sha256": host_leaf_sha256(params),
                   "verify_on_read_s": verify_read_s, **sub.last_fetch,
                   **{k: v for k, v in sub.stats.items()}})
        del params


def phase_weight_sync_7b(device="cuda"):
    """``WS7B_VERSIONS`` versions of a Llama-2-7B-width, 2-layer bf16 tree
    published from the card to a subscriber in a CPU process
    through the run store this process hosts (the first three into new
    payload slots, the rest into reused ones).  Fails unless each version
    is adopted, the digest matches on both sides and every leaf's sha256
    equals the card's."""
    import torch

    from ray_tpu_torch._private import kv as kv_mod, worker_zygote
    from ray_tpu_torch._private.shm import sweep_segments
    from ray_tpu_torch.models.llama import LlamaConfig, llama_init
    from ray_tpu_torch.rl.weight_sync import WeightPublisher
    from ray_tpu_torch.rl.weight_sync import _read_latest_record

    t0 = time.perf_counter()
    kv = kv_mod.host()
    old = os.environ.get(kv_mod.ENV_KV)
    os.environ[kv_mod.ENV_KV] = kv.addr
    cfg = dataclasses.replace(LlamaConfig.llama2_7b(),
                              num_layers=WS7B_LAYERS,
                              param_dtype=torch.bfloat16)
    params = llama_init(cfg, seed=0, device=device)
    nbytes = sum(t.numel() * t.element_size() for t in
                 [params["embed"], params["lm_head"], params["final_norm"],
                  *params["layers"].values()])
    ctx = worker_zygote.get_context()
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=ws7b_subscriber, args=(child, kv.addr),
                       daemon=True, name="ws7b-subscriber")
    t_spawn = time.perf_counter()
    proc.start()
    child.close()
    pub = WeightPublisher("ws7b", resume=False, keep=2)
    versions = []
    try:
        if not parent.poll(300):
            raise AssertionError("weight_sync_7b: the subscriber did not "
                                 "start within 300 s")
        started = parent.recv()
        spawn_to_ready_s = time.perf_counter() - t_spawn
        for i in range(WS7B_VERSIONS):
            if i:  # a new version: every layer's norms and one embed row
                with torch.no_grad():
                    params["final_norm"].add_(1.0)
                    params["embed"][i].add_(1.0)
            t1 = time.perf_counter()
            card = host_leaf_sha256(params)
            card_hash_s = time.perf_counter() - t1
            ver = pub.publish(params)
            committed = _read_latest_record("ws7b")["digest"]
            parent.send(("adopt", ver.version))
            if not parent.poll(600):
                raise AssertionError(f"weight_sync_7b: v{ver.version} not "
                                     "adopted within 600 s")
            got = parent.recv()
            leaves_equal = got["leaf_sha256"] == card
            row = {"version": ver.version, "adopted": got["version"],
                   "publish_ms": {k[:-2]: v * 1e3 for k, v in
                                  pub.last_publish.items()
                                  if k.endswith("_s")},
                   "payload_bytes": pub.last_publish["bytes"],
                   "new_slot": pub.last_publish["new_slot"],
                   "digest_host_gbps": nbytes / pub.last_publish[
                       "digest_s"] / 1e9,
                   "subscriber_fetch_ms": got["fetch_s"] * 1e3,
                   "subscriber_verify_ms": got["verify_s"] * 1e3,
                   "subscriber_verify_on_read_ms":
                       got["verify_on_read_s"] * 1e3,
                   "card_leaf_hash_ms": card_hash_s * 1e3,
                   "digest_equal": got["digest"] == committed,
                   "leaves": len(card), "leaves_bit_equal": leaves_equal,
                   "channel_updates": got["channel_updates"],
                   "rejected": got["rejected"]}
            versions.append(row)
            if not (got["version"] == ver.version and row["digest_equal"]
                    and leaves_equal and got["rejected"] == 0):
                raise AssertionError(f"weight_sync_7b: {row}")
        parent.send(("stop",))
        proc.join(60)
    finally:
        if proc.is_alive():
            proc.kill()
        pub.close()
        sweep_segments(kv)
        if old is None:
            os.environ.pop(kv_mod.ENV_KV, None)
        else:
            os.environ[kv_mod.ENV_KV] = old
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return {"model": "llama2_7b width", "layers": WS7B_LAYERS,
            "dtype": "bfloat16", "bytes": nbytes,
            "subscriber": "a CPU process forked by the worker zygote",
            "subscriber_start_s": started["ready_s"],
            "subscriber_spawn_to_ready_s": spawn_to_ready_s,
            "versions": versions, "phase_s": time.perf_counter() - t0}


def tiered_config(layers=TIERED_LAYERS):
    """``trainer_tiered``'s model: the ``train`` phase's at ``layers``."""
    return dataclasses.replace(train_config(), num_layers=layers)


def tiered_reckoning(storage):
    """The host memory and disk one tiered generation needs at
    ``TIERED_LAYERS`` against what this machine has: the local tier keeps
    two generations and one is in flight, the replica server two and one
    spare buffer, a restore fetches one and reassembles one.  The depth
    is cut to one layer only if that does not fit."""
    import shutil

    def need(layers):
        gen = tiered_config(layers).num_params() * 12
        return gen, {"host": gen * 8, "disk": gen * 2}

    with open("/proc/meminfo") as f:
        mem = {line.split(":")[0]: int(line.split()[1]) * 1024
               for line in f}
    free_disk = shutil.disk_usage(storage).free
    layers = TIERED_LAYERS
    gen, want = need(layers)
    if want["host"] > mem["MemAvailable"] or want["disk"] > free_disk:
        layers = 1
        gen, want = need(layers)
    return layers, {"generation_bytes": gen,
                    "host_bytes_needed": want["host"],
                    "mem_available_bytes": mem["MemAvailable"],
                    "disk_bytes_needed": want["disk"],
                    "disk_free_bytes": free_disk,
                    "layers": layers,
                    "depth_cut": "32 -> %d layers: fp32 params and both "
                                 "AdamW moments, 12 B per param" % layers}


def tiered_card_loop(config):
    """``trainer_tiered``'s loop in its one worker on the card: the
    ``trainer`` phase's step (seed 0, tokens from seed 4) at
    ``config["layers"]`` layers, each of ``TIERED_STEPS`` steps saved
    (params, both AdamW moments, the step) through
    ``ctx.checkpointer()``.  A first attempt hashes its step-2 save,
    waits for its last save's persist at step ``TIERED_FAIL_AT`` after
    that step's loss, and raises; a restarted one restores through
    ``ctx.restore_checkpoint()`` and runs the rest, its last save with
    ``wait_persist=True``.  Reports a start row, one row per step and
    the saves' persist times."""
    t_start = time.time()
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models.training import (default_optimizer,
                                               make_llama_trainer,
                                               tree_leaves)
    from ray_tpu_torch.train import checkpoint_async as ca
    from ray_tpu_torch.train.checkpoint import _place_like

    ctx = train.get_context()
    dev = ctx.get_device()
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    t_cuda = time.time()
    cfg = tiered_config(config["layers"])
    tr = make_llama_trainer(cfg, optimizer=default_optimizer(
        warmup=1, decay_steps=1000), device=dev)
    state = tr.init_state(seed=0)
    gen = torch.Generator(device=dev).manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, SEQ + 1),
                                     generator=gen, device=dev)}
    ckpt = ctx.checkpointer()
    _zero_launches()
    t0 = time.perf_counter()
    res = ctx.restore_checkpoint()
    restore_s = time.perf_counter() - t0
    attempt = "first" if res is None else "restarted"
    start = {"kind": "start", "attempt": attempt, "t_loop_start": t_start,
             "t_cuda_ready": t_cuda}
    if res is not None:
        t1 = time.perf_counter()
        start["restored_sha256"] = host_leaf_sha256(res.tree)
        hash_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        state = _place_like(res.tree, state)
        for t in tree_leaves(state["params"]):
            t.requires_grad_(True)
        torch.cuda.synchronize()
        res_tree, res.tree = res.tree, None
        del res_tree  # the host tree's memory, before the saves want it
        start["restore"] = {
            "index": res.index, "tier": res.tier,
            "disk_reads": res.disk_reads,
            "tier_by_rank": {str(k): v for k, v in res.tier_by_rank.items()},
            "ladder_ms": restore_s * 1e3,
            "ms_by_tier": {k: v * 1e3 for k, v in res.seconds.items()},
            "h2d_ms": (time.perf_counter() - t1) * 1e3,
            "hash_ms": hash_s * 1e3, "step": state["step"]}
    train.report(start)
    handles, buffers = [], set()

    def persisted():
        return [{"index": h.index, "bytes": h.nbytes,
                 "snapshot_ms": h.snapshot_s * 1e3,
                 "push_ms": h.push_s * 1e3, "persist_ms": h.persist_s * 1e3,
                 "ram_acked": h.ram_acked, "tier": h.tier,
                 "committed": bool(h.committed_path)} for h in handles]

    for step in range(state["step"], TIERED_STEPS):
        before = _launch_counts()
        torch.cuda.synchronize()
        c0, p0 = time.thread_time(), time.process_time()
        t0 = time.perf_counter()
        profiled = None
        if attempt == "first" and step == 1 and torch.cuda.is_available():
            # one step under the profiler, a persist in flight beside it
            held = {}
            by_name, split = device_profile(
                lambda: held.update(out=tr.step(state, batch)))
            state, m = held["out"]
            profiled = {"device_busy_ms": split.get("device_busy_ms",
                                                    "not measured"),
                        "call_ms": split.get("call_ms"),
                        "by_class": device_ms_by_class(by_name),
                        "top_kernels": rank_kernels(by_name)[1][:5]}
        else:
            state, m = tr.step(state, batch)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        loss = float(m["loss"])
        compute_ms = (time.perf_counter() - t0) * 1e3
        row = {"kind": "step", "attempt": attempt, "step": step,
               "loss": loss, "compute_ms": compute_ms,
               "enqueue_ms": enqueue_ms,
               "loop_thread_cpu_ms": (time.thread_time() - c0) * 1e3,
               "process_cpu_ms": (time.process_time() - p0) * 1e3,
               "profiled": profiled,
               "k1_k2_k3": [b - a for a, b in zip(before,
                                                  _launch_counts())]}
        if attempt == "first" and step == TIERED_FAIL_AT:
            # the last save's whole persist (its peer push included) ends
            # before the failure, so the restart finds it in peer RAM
            ckpt.wait(600.0)
            row["last_save_ram_acked"] = handles[-1].ram_acked
            row["persisted"] = persisted()
            train.report(row)
            raise RuntimeError(f"injected failure at step {step}, after "
                               "its loss and before its save")
        wait = attempt == "restarted" and step == TIERED_STEPS - 1
        t0 = time.perf_counter()
        h = ckpt.save(state, {"step": step, "loss": loss},
                      wait_persist=wait)
        row.update(stall_ms=(time.perf_counter() - t0) * 1e3,
                   snapshot_ms=h.snapshot_s * 1e3, bytes=h.nbytes,
                   index=h.index, wait_persist=wait)
        ptr = ca._local_get(h.run, h.index, h.rank).data_ptr()
        row["buffer_reused"] = ptr in buffers
        buffers.add(ptr)
        if attempt == "first" and step == TIERED_FAIL_AT - 1:
            t1 = time.perf_counter()
            row["saved_sha256"] = blob_leaf_sha256(
                ca._local_get(h.run, h.index, h.rank))
            row["hash_ms"] = (time.perf_counter() - t1) * 1e3
        handles.append(h)
        train.report(row, checkpoint=h)
    ckpt.wait(600.0)
    train.report({"kind": "persist", "attempt": attempt,
                  "persisted": persisted(),
                  "k4_launches": _all_launches()[3]})


def phase_trainer_tiered(use_gpu=True):
    """``tiered_card_loop`` through ``TorchTrainer`` on the card under
    ``CheckpointConfig(mode="tiered")`` and ``FailureConfig(max_failures
    =1)``.  Fails unless the restarted worker restores from peer RAM with
    0 disk reads, every restored leaf's sha256 equals the step-2 save's,
    its step-3 loss equals the first attempt's bit for bit, and K1, K2
    and K3 launch once per layer per step."""
    import shutil
    import tempfile

    from ray_tpu_torch.train import (CheckpointConfig, FailureConfig,
                                     RunConfig, ScalingConfig, TorchTrainer)

    t0 = time.perf_counter()
    allocated = memory_before_spawn("trainer_tiered")
    tmp = tempfile.mkdtemp(prefix="trainer_tiered_")
    layers, reckoning = tiered_reckoning(tmp)
    emit({"phase": "trainer_tiered_reckoning", **reckoning})
    t_fit = time.time()
    try:
        result = TorchTrainer(
            tiered_card_loop, train_loop_config={"layers": layers},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=use_gpu),
            run_config=RunConfig(
                name="trainer_tiered", storage_path=tmp,
                checkpoint_config=CheckpointConfig(mode="tiered",
                                                   num_to_keep=1),
                failure_config=FailureConfig(max_failures=1))).fit()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fit_s = time.time() - t_fit
    if result.error is not None:
        raise AssertionError(f"trainer_tiered: {result.error}")
    rows = result.metrics_history
    starts = [r for r in rows if r["kind"] == "start"]
    steps = [r for r in rows if r["kind"] == "step"]
    first = {r["step"]: r for r in steps if r["attempt"] == "first"}
    again = {r["step"]: r for r in steps if r["attempt"] == "restarted"}
    restart = next(r for r in starts if r["attempt"] == "restarted")
    restore = restart["restore"]
    saved = first[TIERED_FAIL_AT - 1]["saved_sha256"]
    persist = [r for r in rows if r["kind"] == "persist"]
    per_step = {tuple(r["k1_k2_k3"]) for r in steps}
    async_saves = [r for r in steps if "stall_ms" in r
                   and not r["wait_persist"]]
    sync_save = [r for r in steps if r.get("wait_persist")]
    problems = [name for name, ok in (
        ("restored from peer RAM", restore["tier"] == "memory"
         and set(restore["tier_by_rank"].values()) == {"peer"}),
        ("the step-2 save acked in peer RAM before the failure",
         first[TIERED_FAIL_AT]["last_save_ram_acked"]),
        ("0 disk reads", restore["disk_reads"] == 0),
        ("the step-2 save restored", restore["step"] == TIERED_FAIL_AT),
        ("every leaf's sha256 equal",
         restart["restored_sha256"] == saved and len(saved) > 0),
        ("step 3's loss bit-equal",
         again[TIERED_FAIL_AT]["loss"] == first[TIERED_FAIL_AT]["loss"]),
        ("K1 = K2 = K3 = layers per step", per_step == {(layers,) * 3}),
        ("the restarted worker's fourth save reused a snapshot buffer",
         [r["buffer_reused"] for r in steps if r["attempt"] == "restarted"
          and "stall_ms" in r] == [False] * 3 + [True]))
        if not ok]
    out = {
        "model": "llama2_7b", "layers": layers,
        "depth_cut": reckoning["depth_cut"], "batch": 1, "seq": SEQ,
        "remat_policy": "save_attn", "allocated_before_spawn_gb": allocated,
        "generation_bytes": async_saves[0]["bytes"],
        "steps": [{k: r.get(k) for k in (
            "attempt", "step", "compute_ms", "enqueue_ms",
            "loop_thread_cpu_ms", "process_cpu_ms", "profiled")}
            for r in steps],
        "saves": [{k: r.get(k) for k in (
            "attempt", "step", "index", "compute_ms", "stall_ms",
            "snapshot_ms", "buffer_reused", "wait_persist")} | {
            "snapshot_gbps": r["bytes"] / r["snapshot_ms"] / 1e6}
            for r in steps if "stall_ms" in r],
        "pinned_copy_gbps_data_vit": PINNED_COPY_GBPS,
        "async_save_stall_ms": [r["stall_ms"] for r in async_saves],
        "wait_persist_save_stall_ms": [r["stall_ms"] for r in sync_save],
        "persisted": {r["attempt"]: r["persisted"] for r in persist},
        "first_attempt_at_failure": first[TIERED_FAIL_AT].get("persisted"),
        "restore": restore,
        "losses": {"first": [first[k]["loss"] for k in sorted(first)],
                   "restarted": [again[k]["loss"] for k in sorted(again)]},
        "launches": {**{k: sum(r["k1_k2_k3"][i] for r in steps)
                        for i, k in enumerate(("K1", "K2", "K3"))},
                     "K4": sum(r["k4_launches"] for r in persist)},
        "k1_k2_k3_per_step": sorted(per_step),
        "worker_start_s": [r["t_cuda_ready"] - t_fit for r in starts],
        "fit_s": fit_s, "phase_s": time.perf_counter() - t0}
    if problems:
        raise AssertionError(f"trainer_tiered: failed {problems}: {out}")
    return out


def tiered_phases(smi, names=TIERED_PHASES):
    """The RLHF (with weight_sync_7b) and trainer_tiered phases named in
    ``names``, each printing its line with the card's name and power
    limit; returns their reports by name."""
    import torch

    out = {}
    for name, phase in (("rlhf", phase_rlhf),
                        ("weight_sync_7b", phase_weight_sync_7b),
                        ("trainer_tiered", phase_trainer_tiered)):
        if name not in names and not (name == "weight_sync_7b"
                                      and "rlhf" in names):
            continue
        gc.collect()
        torch.cuda.empty_cache()
        before = _all_launches()
        out[name] = phase()
        out[name]["k1_k2_k3_k4_in_this_process"] = [
            b - a for a, b in zip(before, _all_launches())]
        emit({"phase": name, "card": smi, **out[name]})
    return out


def tiered_launches_by_path(tiered, i):
    """Kernel ``i``'s (K1-K4) launches on the RLHF, weight-sync and
    tiered-trainer paths: ``rlhf``'s and ``trainer_tiered``'s counted in
    their workers (both attempts' steps), ``weight_sync_7b``'s in this
    process."""
    key = ("K1", "K2", "K3", "K4")[i]
    return {"rlhf": tiered["rlhf"]["k1_k2_k3_k4_launches"][i],
            "weight_sync_7b":
                tiered["weight_sync_7b"]["k1_k2_k3_k4_in_this_process"][i],
            "trainer_tiered": tiered["trainer_tiered"]["launches"][key]}


def dag4_or_why():
    """``phase_dag4`` with four or more cards, else why it did not run."""
    import torch

    if torch.cuda.device_count() < MESH4_RANKS:
        return {"ran": False, "why": (
            f"{torch.cuda.device_count()} card(s) present; the phase needs "
            f"{MESH4_RANKS}")}
    return phase_dag4()


def dag_launches(dag_fwd, dag_pipe, dag4, i):
    """Kernel ``i``'s launches (K1-K4) on the DAG paths, counted in their
    stage processes: ``dag_forward``'s timed executions and
    ``dag_pipeline``'s timed run by stage, and per step by rank on
    ``dag4`` when it ran."""
    out = {"dag_forward_by_stage": [
        c[i] for c in dag_fwd["k1_k2_k3_k4_launches_by_stage"]],
        "dag_pipeline_by_stage": [
        c[i] for c in dag_pipe["k1_k2_k3_k4_launches_by_stage"]]}
    if dag4.get("ran"):
        out["dag4_per_step_by_rank"] = [
            c[i] for c in dag4["k1_k2_k3_k4_per_step_by_rank"]]
    return out


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the "
              "port on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ray_tpu_torch.models.llama import LlamaConfig, llama_init
    from ray_tpu_torch.models.moe import MoEConfig, make_moe_trainer

    if set(argv) - FOUR_CARD_PHASES - DATA_PHASES - SERVING_PHASES \
            - RL_PHASES - TIERED_PHASES - DAG_PHASES - {"startup",
                                                        "mesh_group"}:
        raise SystemExit(f"chip_smoke: unknown arguments {argv}")
    smi = phase_env()
    if argv:
        if "startup" in argv:
            emit({"phase": "startup", **phase_startup()})
        if "mesh_group" in argv:
            emit({"phase": "mesh_group", **phase_mesh_group()})
        if "mesh_group4" in argv:
            emit({"phase": "mesh_group4", **mesh_group4_or_why()})
        if "serve_mesh4" in argv:
            cfg = dataclasses.replace(LlamaConfig.llama2_7b(),
                                      param_dtype=torch.bfloat16)
            params = llama_init(cfg, seed=0, device="cuda")
            serve = phase_serve(cfg, params)
            emit({"phase": "serve", "decode_tokens_per_s":
                  serve["decode_tokens_per_s"],
                  "decode_profile": serve["decode_profile"]})
            report = phase_serve_mesh4(cfg, params, serve)
            emit({"phase": "serve_mesh4", **report})
            del params
            gc.collect()
            torch.cuda.empty_cache()
            check_serve_mesh4(report)
        if "mesh4" in argv or "trainer4" in argv:
            mesh4 = phase_mesh4()
            emit({"phase": "mesh4", **mesh4})
            if "trainer4" in argv:
                emit({"phase": "trainer4", "model": "llama2_7b",
                      **phase_trainer4(mesh4)})
        if "health4" in argv:
            emit({"phase": "health4", **phase_health4()})
        if "dag4" in argv:
            emit({"phase": "dag4", "model": "llama2_7b", **dag4_or_why()})
        if "dag_forward" in argv:
            cfg = dataclasses.replace(LlamaConfig.llama2_7b(),
                                      param_dtype=torch.bfloat16)
            params = llama_init(cfg, seed=0, device="cuda")
            fwd = phase_forward(cfg, params)
            emit({"phase": "forward", "forward_ms": fwd["forward_ms"],
                  "k1_launches": fwd["k1_launches"]})
            dag_fwd = phase_dag_forward(cfg, params, fwd)
            emit({"phase": "dag_forward", "model": "llama2_7b",
                  "layers": cfg.num_layers, "depth_cut": False, "batch": 1,
                  "seq": SEQ, **dag_fwd})
            check_dag_forward(dag_fwd)
            del params
            gc.collect()
            torch.cuda.empty_cache()
        if "dag_pipeline" in argv:
            train_cfg = train_config()
            train = phase_train(train_cfg)
            emit({"phase": "train", "step_ms": train["step_ms"],
                  "optimizer_ms": train["optimizer_ms"],
                  "launches": train["launches"]})
            gc.collect()
            torch.cuda.empty_cache()
            dag_pipe = phase_dag_pipeline(train_cfg, train)
            emit({"phase": "dag_pipeline", "model": "llama2_7b",
                  "layers": TRAIN_LAYERS, "depth_cut": DEPTH_CUT,
                  **dag_pipe})
            check_dag_pipeline(dag_pipe)
        if "data_trainer" in argv:
            train_cfg = train_config()
            train = phase_train(train_cfg)
            emit({"phase": "train", "model": "llama2_7b",
                  "layers": TRAIN_LAYERS, **train})
            check_train("train", train, {"K1": TRAIN_LAYERS,
                                         "K2": TRAIN_LAYERS,
                                         "K3": TRAIN_LAYERS})
            gc.collect()
            torch.cuda.empty_cache()
            trainer = phase_trainer(train)
            emit({"phase": "trainer", "model": "llama2_7b", **trainer})
            emit({"phase": "data_trainer", "model": "llama2_7b",
                  "layers": TRAIN_LAYERS, "depth_cut": DEPTH_CUT,
                  "batch": 1, "seq": SEQ,
                  "remat_policy": train_cfg.remat_policy,
                  **phase_data_trainer(trainer)})
        if SERVING_PHASES & set(argv):
            cfg = dataclasses.replace(LlamaConfig.llama2_7b(),
                                      param_dtype=torch.bfloat16)
            params = llama_init(cfg, seed=0, device="cuda")
            serving_front(cfg, params, smi, SERVING_PHASES & set(argv))
            del params
            gc.collect()
            torch.cuda.empty_cache()
        if "data_vit" in argv:
            gc.collect()
            torch.cuda.empty_cache()
            vit = phase_vit_train()
            emit({"phase": "vit_train", **vit})
            gc.collect()
            torch.cuda.empty_cache()
            emit({"phase": "data_vit", **phase_data_vit(vit)})
        if RL_PHASES & set(argv):
            rl_phases(smi, RL_PHASES & set(argv))
        if TIERED_PHASES & set(argv):
            tiered_phases(smi, TIERED_PHASES & set(argv))
        print(smi, flush=True)
        emit({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return 0
    k1 = phase_kernels()
    k4 = phase_kernels_k4()
    emit({"phase": "small_reference", **phase_small_reference()})
    emit({"phase": "vit_small_reference", **phase_vit_small_reference()})
    startup = phase_startup()
    emit({"phase": "startup", **startup})
    emit({"phase": "channel", **phase_channel()})
    ring = phase_ring()
    emit({"phase": "ring", **ring})
    mesh_group = phase_mesh_group()
    emit({"phase": "mesh_group", **mesh_group})
    mesh_group4 = mesh_group4_or_why()
    emit({"phase": "mesh_group4", **mesh_group4})

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
    dag_fwd = phase_dag_forward(cfg, params, fwd)
    emit({"phase": "dag_forward", "model": "llama2_7b",
          "layers": cfg.num_layers, "depth_cut": False, "batch": 1,
          "seq": SEQ, **dag_fwd})
    check_dag_forward(dag_fwd)
    torch.cuda.reset_peak_memory_stats()
    serve = phase_serve(cfg, params)
    single = {k: serve.pop(k) for k in ("first_token_logits",
                                        "first_decode_logits")}
    emit({"phase": "serve", "model": "llama2_7b", "slots": SERVE_SLOTS,
          "max_len": SERVE_MAX_LEN, "block_size": SERVE_BLOCK,
          **{k: v for k, v in serve.items() if k != "token_ids"},
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    serve_mesh = phase_serve_mesh(cfg, params, serve)
    for k in ("first_token_logits", "first_decode_logits", "token_ids"):
        del serve_mesh[k]
    emit({"phase": "serve_mesh", "model": "llama2_7b", "layers":
          cfg.num_layers, "depth_cut": False, "slots": SERVE_SLOTS,
          "max_len": SERVE_MAX_LEN, "block_size": SERVE_BLOCK, **serve_mesh})
    colocated = serve.pop("token_ids")
    serve_mesh4 = None
    if torch.cuda.device_count() >= MESH4_RANKS:
        gc.collect()
        torch.cuda.empty_cache()
        serve_mesh4 = phase_serve_mesh4(cfg, params,
                                        {**single, "token_ids": colocated})
        emit({"phase": "serve_mesh4", "model": "llama2_7b", **serve_mesh4})
        check_serve_mesh4(serve_mesh4)
    else:
        emit({"phase": "serve_mesh4", "ran": False, "why": (
            f"{torch.cuda.device_count()} card(s) present; the phase needs "
            f"{MESH4_RANKS}")})
    t0 = time.perf_counter()
    options = phase_serve_options(cfg, params)
    emit({"phase": "serve_options", "model": "llama2_7b",
          "layers": cfg.num_layers, "depth_cut": False,
          "max_len": SERVE_MAX_LEN, "block_size": SERVE_BLOCK,
          "spec_tokens": SPEC_TOKENS, **options,
          "phase_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    disagg = phase_disagg(cfg, params, colocated)
    emit({"phase": "disagg", "model": "llama2_7b", "layers": cfg.num_layers,
          "depth_cut": False, "max_len": SERVE_MAX_LEN,
          "block_size": SERVE_BLOCK, "slots": SERVE_SLOTS, **disagg,
          "phase_s": time.perf_counter() - t0})
    # the serving front: replica processes on this card, shut down before
    # the training phases
    front = serving_front(cfg, params, smi)

    del params
    gc.collect()
    torch.cuda.empty_cache()
    train_cfg = train_config()
    train = phase_train(train_cfg)
    emit({"phase": "train", "model": "llama2_7b", "layers": TRAIN_LAYERS,
          "depth_cut": DEPTH_CUT, "batch": 1, "seq": SEQ,
          "remat_policy": train_cfg.remat_policy,
          "params_b": train_cfg.num_params() / 1e9, **train})
    check_train("train", train, {"K1": TRAIN_LAYERS, "K2": TRAIN_LAYERS,
                                 "K3": TRAIN_LAYERS})
    gc.collect()
    torch.cuda.empty_cache()
    dag_pipe = phase_dag_pipeline(train_cfg, train)
    emit({"phase": "dag_pipeline", "model": "llama2_7b",
          "layers": TRAIN_LAYERS, "depth_cut": DEPTH_CUT, **dag_pipe})
    check_dag_pipeline(dag_pipe)
    gc.collect()
    torch.cuda.empty_cache()
    mesh = phase_mesh(train_cfg, train)
    emit({"phase": "mesh", "model": "llama2_7b", "layers": TRAIN_LAYERS,
          "depth_cut": DEPTH_CUT, "batch": 1, "seq": SEQ,
          "remat_policy": train_cfg.remat_policy, **mesh})
    check_train("mesh", mesh, {"K1": TRAIN_LAYERS, "K2": TRAIN_LAYERS,
                               "K3": TRAIN_LAYERS})
    mesh4 = None
    if torch.cuda.device_count() >= MESH4_RANKS:
        gc.collect()
        torch.cuda.empty_cache()
        mesh4 = phase_mesh4()
        emit({"phase": "mesh4", **mesh4})
    gc.collect()
    torch.cuda.empty_cache()
    trainer = phase_trainer(train)
    emit({"phase": "trainer", "model": "llama2_7b", "layers": TRAIN_LAYERS,
          "depth_cut": DEPTH_CUT, "batch": 1, "seq": SEQ,
          "remat_policy": train_cfg.remat_policy, **trainer})
    resume = phase_trainer_resume()
    emit({"phase": "trainer_resume", **resume})
    gc.collect()
    torch.cuda.empty_cache()
    data_trainer = phase_data_trainer(trainer)
    emit({"phase": "data_trainer", "model": "llama2_7b",
          "layers": TRAIN_LAYERS, "depth_cut": DEPTH_CUT, "batch": 1,
          "seq": SEQ, "remat_policy": train_cfg.remat_policy,
          **data_trainer})
    trainer4 = None
    if mesh4 is not None:
        trainer4 = phase_trainer4(mesh4)
        emit({"phase": "trainer4", "model": "llama2_7b", **trainer4})
    else:
        emit({"phase": "trainer4", "ran": False, "why": (
            f"{torch.cuda.device_count()} card(s) present; the phase needs "
            f"{MESH4_RANKS}")})
    # the other policies from the same seed and tokens: the forward does
    # not depend on the policy, so the first step's loss is bit-equal
    policies = {}
    for policy in ("save_attn_mlp", "save_dots"):
        gc.collect()
        torch.cuda.empty_cache()
        cfg_p = dataclasses.replace(train_cfg, remat_policy=policy)
        run_p = phase_train(cfg_p, steps=POLICY_STEPS, warmup=POLICY_WARMUP)
        norm_diff = run_p["grad_norms"][0] - train["grad_norms"][0]
        run_p.update(first_loss_bit_equal_to_save_attn=run_p["losses"][0]
                     == train["losses"][0],
                     first_grad_norm_minus_save_attn=norm_diff,
                     first_grad_norm_rel_diff=abs(norm_diff)
                     / train["grad_norms"][0])
        emit({"phase": f"train_{policy}", "model": "llama2_7b",
              "layers": TRAIN_LAYERS, "depth_cut": DEPTH_CUT, "batch": 1,
              "seq": SEQ, "remat_policy": policy, **run_p})
        check_train(f"train_{policy}", run_p,
                    {"K1": TRAIN_LAYERS * (2 if policy == "save_dots" else 1),
                     "K2": TRAIN_LAYERS, "K3": TRAIN_LAYERS})
        if not (run_p["first_loss_bit_equal_to_save_attn"]
                and run_p["first_grad_norm_rel_diff"] <= 1e-3):
            raise AssertionError(
                f"{policy}: first step's loss {run_p['losses'][0]} and grad "
                f"norm {run_p['grad_norms'][0]}, save_attn's "
                f"{train['losses'][0]} and {train['grad_norms'][0]} (loss "
                "bit-equal, grad norm to rtol 1e-3)")
        policies[policy] = run_p

    gc.collect()
    torch.cuda.empty_cache()
    moe_fwd = phase_moe_forward()
    emit({"phase": "moe_forward", **moe_fwd})
    gc.collect()
    torch.cuda.empty_cache()
    moe_cfg = dataclasses.replace(
        MoEConfig.mixtral_8x7b(), num_layers=MOE_TRAIN_LAYERS,
        param_dtype=torch.float32, dtype=torch.bfloat16)
    # FLOPs per step as the JAX bench counts them (forward and backward,
    # 3x the forward; the replay not counted), by dense dispatch and by
    # the active top-2 experts
    moe_train = phase_train(
        moe_cfg, make_trainer=make_moe_trainer,
        flops=3 * moe_forward_flops(moe_cfg, 1, SEQ, moe_cfg.num_experts))
    active = 3 * moe_forward_flops(moe_cfg, 1, SEQ,
                                   moe_cfg.experts_per_token)
    emit({"phase": "moe_train", "model": "mixtral_8x7b",
          "layers": MOE_TRAIN_LAYERS, "depth_cut": MOE_TRAIN_CUT,
          "batch": 1, "seq": SEQ, "remat": "full (the reference's)",
          "params_b": moe_cfg.num_params() / 1e9,
          "train_flops_active_top2": active,
          "mfu_by_active_top2_flops": active * moe_train["tokens_per_s"]
          / SEQ / PEAK_FLOPS["bfloat16"], **moe_train})
    check_train("moe_train", moe_train, {"K1": 2 * MOE_TRAIN_LAYERS,
                                         "K2": MOE_TRAIN_LAYERS,
                                         "K3": MOE_TRAIN_LAYERS})
    gc.collect()
    torch.cuda.empty_cache()
    vit = phase_vit_train()
    emit({"phase": "vit_train", **vit})
    gc.collect()
    torch.cuda.empty_cache()
    data_vit = phase_data_vit(vit)
    emit({"phase": "data_vit", **data_vit})
    gc.collect()
    torch.cuda.empty_cache()
    health = phase_health()
    emit({"phase": "health", **health})
    health4 = None
    if torch.cuda.device_count() >= MESH4_RANKS:
        health4 = phase_health4()
        emit({"phase": "health4", **health4})
    else:
        emit({"phase": "health4", "ran": False, "why": (
            f"{torch.cuda.device_count()} card(s) present; the phase needs "
            f"{MESH4_RANKS}")})
    gc.collect()
    torch.cuda.empty_cache()
    dag4 = dag4_or_why()
    emit({"phase": "dag4", "model": "llama2_7b", **dag4})

    # the RL stack: rollouts and updates on the card, host runner
    # processes; none of K1-K4 on its paths
    rl = rl_phases(smi)
    # the RLHF loop, weight sync and the tiered checkpoint plane
    tiered = tiered_phases(smi)

    main_case = k1["main_path"]
    row1, bwd = main_case["k1"], main_case["bwd"]
    gqa1, gqa_bwd = k1["mixtral_gqa"]["k1"], k1["mixtral_gqa"]["bwd"]
    train_paths = {"train": train, "mesh": mesh, "moe_train": moe_train,
                   **{f"train_{p}": r for p, r in policies.items()}}

    def by_path(name):
        """Kernel ``name``'s launches on each train path (the trainer
        paths' in their workers: ``trainer``'s and ``data_trainer``'s
        timed steps, all of ``trainer_resume``'s steps, rank 0's timed
        ``trainer4`` steps)."""
        out = {path: run["launches"][name]
               for path, run in train_paths.items()}
        out["trainer"] = trainer["launches"][name]
        out["trainer_resume"] = resume["launches"][name]
        out["data_trainer"] = data_trainer["launches"][name]
        out["vit_train"] = vit["launches"][name]
        out["data_vit"] = data_vit["launches"][name]
        if trainer4 is not None:
            out["trainer4"] = int(MESH_STEPS * trainer4["k1_k2_k3_per_step"][
                ("K1", "K2", "K3").index(name)])
        return out

    def serving(i):
        """Kernel ``i``'s launches (K1-K4) on the serving mesh paths and
        the serving front (``llm_server`` and ``llm_disagg``: counted in
        their replica processes; ``llm_batch`` in this process): none, as
        on ``serve`` (the engine's attention is plain)."""
        name = ("K1", "K2", "K3", "K4")[i]
        disagg_counts = front["llm_disagg"]["k1_k2_k3_k4_launches"]
        out = {"serve_mesh": serve_mesh["k1_k2_k3_k4_launches"][i],
               "llm_server": front["llm_server"][
                   "k1_k2_k3_k4_launches"][name],
               "llm_disagg": sum(c[name] for c in disagg_counts.values()),
               "llm_batch": front["llm_batch"]["k1_k2_k3_k4_launches"][i]}
        if serve_mesh4 is not None:
            out["serve_mesh4"] = sum(
                counts[i] for m in SERVE_MESH4_MESHES for counts in
                serve_mesh4[m]["k1_k2_k3_k4_launches_by_rank"])
        return out

    def gqa_bwd_row(kname):
        return {"ms": gqa_bwd[f"{kname}_ms"],
                "bound_ms": gqa_bwd[f"{kname}_bound_ms"],
                "bound_by": gqa_bwd[f"{kname}_bound_by"],
                "bound_share": gqa_bwd[f"{kname}_bound_share"],
                "plain_ms": gqa_bwd["plain_ms"],
                "library_ms": gqa_bwd["library_ms"]}

    # K4 in the health probe's ring ping: per probe, none with one card
    health_pings = {"health_probe": health["probe_cuda0"].get(
        "ping_k4_launches", 0)}
    if health4 is not None:
        health_pings["health4_per_probe"] = health4["k4_launches_per_probe"]
    source = "ray_tpu_torch/ops/cuda/csrc/"
    replaces = "ray_tpu/ops/pallas/flash_attention.py:"
    emit({"kernels": [
        {"name": "K1 flash_fwd", "route": "cuda",
         "source": source + "flash_fwd.cu", "replaces": replaces + "45",
         "launches": train["launches"]["K1"],
         "launches_by_path": {"startup": startup["k1_launches"],
                              "forward": fwd["k1_launches"],
                              **dag_launches(dag_fwd, dag_pipe, dag4, 0),
                              "serve": serve["k1_launches"],
                              "disagg": disagg["k1_launches"],
                              "moe_forward": moe_fwd["k1_launches"],
                              **by_path("K1"), **serving(0),
                              **rl_launches_by_path(rl, 0),
                              **tiered_launches_by_path(tiered, 0)},
         "max_abs_err": row1["max_abs_err"], "ms": row1["ms"],
         "plain_ms": row1["plain_ms"], "bound_ms": row1["bound_ms"],
         "bound_by": row1["bound_by"], "library_ms": row1["library_ms"],
         "tflops": row1["tflops"], "bound_share": row1["bound_share"],
         "mixtral_gqa": {k: gqa1[k] for k in (
             "max_abs_err", "ms", "bound_ms", "bound_by", "bound_share",
             "plain_ms", "library_ms")}},
        {"name": "K2 flash_bwd_dq", "route": "cuda",
         "source": source + "flash_bwd.cu", "replaces": replaces + "195",
         "design": bwd["k2_design"], "launches": train["launches"]["K2"],
         "launches_by_path": {**by_path("K2"), **serving(1),
                              **dag_launches(dag_fwd, dag_pipe, dag4, 1),
                              **rl_launches_by_path(rl, 1),
                              **tiered_launches_by_path(tiered, 1)},
         "max_abs_err": bwd["dq_max_abs_err"],
         "dq_flipped_vs_exact": bwd["dq_flipped_vs_exact"],
         "ms": bwd["k2_ms"],
         "plain_ms": bwd["plain_ms"], "bound_ms": bwd["k2_bound_ms"],
         "bound_by": bwd["k2_bound_by"], "library_ms": bwd["library_ms"],
         "tflops": bwd["k2_tflops"], "bound_share": bwd["k2_bound_share"],
         "mixtral_gqa": {"max_abs_err": gqa_bwd["dq_max_abs_err"],
                         **gqa_bwd_row("k2")}},
        {"name": "K3 flash_bwd_dkv", "route": "cuda",
         "source": source + "flash_bwd.cu", "replaces": replaces + "232",
         "launches": train["launches"]["K3"],
         "launches_by_path": {**by_path("K3"), **serving(2),
                              **dag_launches(dag_fwd, dag_pipe, dag4, 2),
                              **rl_launches_by_path(rl, 2),
                              **tiered_launches_by_path(tiered, 2)},
         "max_abs_err": max(bwd["dk_max_abs_err"], bwd["dv_max_abs_err"]),
         "ms": bwd["k3_ms"], "plain_ms": bwd["plain_ms"],
         "bound_ms": bwd["k3_bound_ms"], "bound_by": bwd["k3_bound_by"],
         "library_ms": bwd["library_ms"],
         "tflops": bwd["k3_tflops"], "bound_share": bwd["k3_bound_share"],
         "mixtral_gqa": {"max_abs_err": max(gqa_bwd["dk_max_abs_err"],
                                            gqa_bwd["dv_max_abs_err"]),
                         **gqa_bwd_row("k3")}},
        {"name": "K4 remote_copy", "route": "cuda",
         "source": source + "remote_copy.cu",
         "replaces": "ray_tpu/experimental/channel/transport.py:285",
         "design": k4["design"], "launches": ring["k4_launches"],
         "launches_by_path": {"ring": ring["k4_launches"],
                              "mesh_group": mesh_group["k4_launches"],
                              **({"mesh_group4": mesh_group4["k4_launches"]}
                                 if "k4_launches" in mesh_group4 else {}),
                              **serving(3),
                              **dag_launches(dag_fwd, dag_pipe, dag4, 3),
                              **health_pings, **rl_launches_by_path(rl, 3),
                              **tiered_launches_by_path(tiered, 3)},
         "max_abs_err": k4["max_abs_err"],
         "ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
         "library_ms": k4["library_ms"], "bound_share": k4["bound_share"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
