"""Port parity: the collective front (``ray_tpu_torch.util.collective``:
``init_collective_group`` over gloo, the supervised ops, the watchdog)
against the reference's ``XlaMeshGroup(4)`` on four CPU devices.

Four gloo ranks (``test_torch_trainer_loops.collective_rank``, spawned
once for the module, one thread each, joined with a timeout that kills
them) meet through a run store this process hosts, run every op on
per-rank numpy inputs from a seed, then the watchdog case; JAX's side
runs here after them, on the stacked inputs.
"""

import multiprocessing
import pickle
import time

import jax
import numpy as np
import pytest

import test_torch_trainer_loops as loops
from ray_tpu.util.collective.collective_group.xla_group import XlaMeshGroup
from ray_tpu.util.collective.types import ReduceOp as JReduceOp
from ray_tpu_torch._private import kv as kv_mod

WORLD = 4
SPAWN_TIMEOUT_S = 240
# random fp32 summed over four ranks in another order than XLA's
RAND_ATOL = 1e-6
PERMS = {"ring": [(0, 1), (1, 2), (2, 3), (3, 0)],
         "swap_and_gap": [(0, 2), (2, 0), (1, 3)]}


def _inputs():
    rng = np.random.default_rng(0)
    return {
        # integer-valued fp32: every reduction is exact in any order
        "ints": rng.integers(-3, 4, (WORLD, 6, 5)).astype(np.float32),
        "rand": rng.standard_normal((WORLD, 6, 5)).astype(np.float32),
        "scatter_ints": rng.integers(-3, 4, (WORLD, WORLD, 3)).astype(
            np.float32),
        "scatter_rand": rng.standard_normal((WORLD, WORLD, 3)).astype(
            np.float32),
        "int64": rng.integers(-2**40, 2**40, (7,)),
        "perms": PERMS,
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn the ranks, join them within ``SPAWN_TIMEOUT_S`` (killing
    them and failing past it), then compute JAX's side; returns
    ``(inputs, per-rank results, JAX results)``."""
    work = tmp_path_factory.mktemp("collective_ranks")
    inputs = _inputs()
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    kv = kv_mod.host()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=loops.collective_rank,
                         args=(r, WORLD, kv.addr, str(work / "inputs.pkl"),
                               str(work)), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} did not finish in {SPAWN_TIMEOUT_S} s"
    got = []
    for r in range(WORLD):
        with open(work / f"rank{r}.pkl", "rb") as f:
            res = pickle.load(f)
        assert "error" not in res, f"rank {r}:\n{res['error']}"
        got.append(res)
    return inputs, got, _jax_refs(inputs)


def _jax_refs(inputs):
    g = XlaMeshGroup(WORLD, devices=jax.devices()[:WORLD])
    out = {}
    for op in ("sum", "product", "min", "max"):
        for kind, key in (("int", "ints"), ("rand", "rand")):
            out[f"allreduce_{kind}_{op}"] = np.asarray(
                g.allreduce(inputs[key], JReduceOp(op)))
    out["allgather"] = np.asarray(g.allgather(inputs["rand"]))
    out["reducescatter_int"] = np.asarray(g.reducescatter(
        inputs["scatter_ints"]))
    out["reducescatter_rand"] = np.asarray(g.reducescatter(
        inputs["scatter_rand"]))
    out["broadcast"] = np.asarray(g.broadcast(inputs["rand"], 2))
    for name, perm in PERMS.items():
        out[f"permute_{name}"] = np.asarray(g.permute(inputs["rand"], perm))
    return out


@pytest.mark.parametrize("op", ["sum", "product", "min", "max"])
def test_allreduce_matches_xla_mesh_group(runs, op):
    """Every rank's allreduce equals ``XlaMeshGroup``'s: exactly for
    integer-valued fp32, to ``RAND_ATOL`` for random fp32."""
    _, got, want = runs
    for r in range(WORLD):
        ops = got[r]["ops"]
        np.testing.assert_array_equal(ops[f"allreduce_int_{op}"],
                                      want[f"allreduce_int_{op}"])
        np.testing.assert_allclose(ops[f"allreduce_rand_{op}"],
                                   want[f"allreduce_rand_{op}"],
                                   atol=RAND_ATOL, rtol=0)


def test_allreduce_of_a_tensor_and_reduce(runs):
    """A torch tensor in gives a torch tensor out; ``reduce`` gives every
    rank the reduction, as the reference's groups do."""
    _, got, want = runs
    for r in range(WORLD):
        ops = got[r]["ops"]
        assert type(ops["allreduce_torch"]).__name__ == "Tensor"
        np.testing.assert_array_equal(ops["allreduce_torch"].numpy(),
                                      want["allreduce_int_sum"])
        np.testing.assert_array_equal(ops["reduce"],
                                      want["allreduce_int_sum"])


def test_allgather_matches_xla_mesh_group(runs):
    _, got, want = runs
    for r in range(WORLD):
        np.testing.assert_array_equal(got[r]["ops"]["allgather"],
                                      want["allgather"])


@pytest.mark.parametrize("kind", ["int", "rand"])
def test_reducescatter_matches_xla_mesh_group(runs, kind):
    """Rank r's slice of dim 0 of the sum equals row r of
    ``XlaMeshGroup.reducescatter``."""
    _, got, want = runs
    for r in range(WORLD):
        out = got[r]["ops"][f"reducescatter_{kind}"]
        assert out.shape == (1, 3)
        if kind == "int":
            np.testing.assert_array_equal(out[0], want["reducescatter_int"][r])
        else:
            np.testing.assert_allclose(out[0], want["reducescatter_rand"][r],
                                       atol=RAND_ATOL, rtol=0)


def test_broadcast_matches_xla_mesh_group(runs):
    _, got, want = runs
    for r in range(WORLD):
        np.testing.assert_array_equal(got[r]["ops"]["broadcast"],
                                      want["broadcast"][r])


@pytest.mark.parametrize("name", sorted(PERMS))
def test_permute_matches_xla_mesh_group(runs, name):
    """``permute`` by send/recv pairs equals ``ppermute``: a ring, and a
    swap with a rank that receives nothing (zeros)."""
    _, got, want = runs
    for r in range(WORLD):
        np.testing.assert_array_equal(got[r]["ops"][f"permute_{name}"],
                                      want[f"permute_{name}"][r])


def test_send_recv_and_barrier(runs):
    """send/recv deliver the sender's array (fp32 and int64) with its
    dtype; no rank leaves the barrier before the last (rank 3, one second
    late) enters it."""
    inputs, got, _ = runs
    np.testing.assert_array_equal(got[1]["ops"]["recv"], inputs["rand"][0])
    recv64 = got[3]["ops"]["recv_int64"]
    assert recv64.dtype == np.int64
    np.testing.assert_array_equal(recv64, inputs["int64"])
    last_in = max(g["ops"]["barrier_enter"] for g in got)
    assert all(g["ops"]["barrier_exit"] >= last_in for g in got)
    assert all(g["ops_state"] == "READY" for g in got)


def test_watchdog_aborts_skipped_allreduce(runs):
    """The reference's ``TestCollectiveWatchdog``: rank 3 skips an
    allreduce; ranks 0-2 raise ``CollectiveAbortError`` within the
    group's timeout + 5 s, read ABORTED, and their flight recorder's tail
    names the op and its sequence number."""
    _, got, _ = runs
    for r in range(3):
        wd = got[r]["watchdog"]
        assert wd["error"] is not None, f"rank {r} did not abort"
        kind, text, seq = wd["error"]
        assert kind == "CollectiveAbortError", text
        assert wd["elapsed_s"] < wd["timeout_s"] + 5, wd["elapsed_s"]
        assert wd["state"] == "ABORTED"
        assert seq == 1 and "seq=1 op=allreduce" in text, text
        last = wd["flight"][-1]
        assert (last["op"], last["seq"], last["status"]) == \
            ("allreduce", 1, "aborted")
