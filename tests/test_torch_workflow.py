"""Port parity: durable workflows over the port's DAG
(``ray_tpu_torch.workflow``) against ``ray_tpu.workflow``.

The cases of ``tests/test_workflow_and_shims.py:32-98`` (run and output,
a resume that skips completed steps, the metadata's step counts), each
run through both packages on the same DAG and arguments, with storage
roots of their own: outputs, statuses, step counts and the step ids (the
names of the checkpoint files, content hashes of each step's function and
lineage) are held equal.  Then the rest of the API: input attributes and
a multi-output DAG, ``run_async``, ``delete``, the storage root from the
environment, and the refusal of an actor step.

The reference's steps run as tasks on the shared test cluster
(``ray_start``); the port's on a thread pool of this process.  Step
functions are defined inside each test: the reference's travel to its
workers by value.
"""

import os

import pytest

import ray_tpu
from ray_tpu import workflow as jwf
from ray_tpu.dag import dag_node as jnode
from ray_tpu_torch import actor as tactor
from ray_tpu_torch import workflow as twf
from ray_tpu_torch.dag import dag_node as tnode

PACKAGES = {"reference": (ray_tpu.remote, jnode, jwf),
            "port": (tactor.remote, tnode, twf)}


@pytest.fixture
def roots(tmp_path):
    """One storage root per package."""
    return {p: str(tmp_path / p) for p in PACKAGES}


def _steps(root, wid):
    return sorted(os.listdir(os.path.join(root, wid, "steps")))


def _status_name(status):
    return None if status is None else status.value


def test_workflow_run_and_output(ray_start, roots):
    def add(x, y):
        return x + y

    def mul(x, k):
        return x * k

    seen = {}
    for p, (remote, node, wf) in PACKAGES.items():
        r_add, r_mul = remote(add), remote(mul)
        with node.InputNode() as inp:
            dag = r_add.bind(r_mul.bind(inp, 3), 10)
        out = wf.run(dag, 5, workflow_id="w1", storage=roots[p])
        seen[p] = (out, _status_name(wf.get_status("w1", storage=roots[p])),
                   wf.get_output("w1", storage=roots[p]),
                   [(w, _status_name(s))
                    for w, s in wf.list_all(storage=roots[p])],
                   _steps(roots[p], "w1"))
    assert seen["port"] == seen["reference"]
    assert seen["port"][:4] == (25, "SUCCESSFUL", 25, [("w1", "SUCCESSFUL")])
    assert len(seen["port"][4]) == 2


def test_workflow_resume_skips_completed_steps(ray_start, roots):
    seen = {}
    for p, (remote, node, wf) in PACKAGES.items():
        os.makedirs(roots[p])
        marker = os.path.join(roots[p], "calls.txt")
        fail_flag = os.path.join(roots[p], "fail")

        def counted(x):
            with open(marker, "a") as f:
                f.write("x")
            return x + 1

        def boom(x, should_fail_file):
            if os.path.exists(should_fail_file):
                raise RuntimeError("transient")
            return x * 100

        r_counted, r_boom = remote(counted), remote(boom)
        open(fail_flag, "w").close()
        with node.InputNode() as inp:
            dag = r_boom.bind(r_counted.bind(inp), fail_flag)
        with pytest.raises(Exception, match="transient"):
            wf.run(dag, 1, workflow_id="w2", storage=roots[p])
        status = _status_name(wf.get_status("w2", storage=roots[p]))
        first_calls = len(open(marker).read())
        steps_after_failure = _steps(roots[p], "w2")
        os.unlink(fail_flag)  # clear the fault
        with node.InputNode() as inp:
            dag2 = r_boom.bind(r_counted.bind(inp), fail_flag)
        out = wf.resume("w2", dag2, storage=roots[p])
        meta = wf.get_metadata("w2", storage=roots[p])
        seen[p] = (status, first_calls, len(steps_after_failure), out,
                   len(open(marker).read()), meta["status"],
                   meta["steps_restored"], meta["steps_executed"])
    assert seen["port"] == seen["reference"]
    # the counted step restored from its checkpoint, not run again
    assert seen["port"] == ("RESUMABLE", 1, 1, 200, 1, "SUCCESSFUL", 1, 1)


def test_workflow_metadata_counts(ray_start, roots):
    def add(x, y):
        return x + y

    seen = {}
    for p, (remote, node, wf) in PACKAGES.items():
        r_add = remote(add)
        with node.InputNode() as inp:
            dag = r_add.bind(inp, 1)
        wf.run(dag, 1, workflow_id="w3", storage=roots[p])
        first = wf.get_metadata("w3", storage=roots[p])
        with node.InputNode() as inp:
            dag2 = r_add.bind(inp, 1)
        wf.resume("w3", dag2, storage=roots[p])  # everything restores
        again = wf.get_metadata("w3", storage=roots[p])
        seen[p] = (first["steps_executed"], first["steps_restored"],
                   again["steps_executed"], again["steps_restored"],
                   wf.get_output("w3", storage=roots[p]))
    assert seen["port"] == seen["reference"] == (1, 0, 0, 1, 2)


def test_input_attributes_and_multi_output(ray_start, roots):
    """``inp[0]``, ``inp.key`` and a ``MultiOutputNode``: the same
    outputs and step ids in both packages, and a changed constant
    changes the step's id."""
    def add(x, y):
        return x + y

    def mul(x, k):
        return x * k

    seen = {}
    for p, (remote, node, wf) in PACKAGES.items():
        r_add, r_mul = remote(add), remote(mul)
        with node.InputNode() as inp:
            s = r_add.bind(inp[0], inp.k)
            dag = node.MultiOutputNode([r_mul.bind(s, 2), r_mul.bind(s, 3)])
        out = wf.run(dag, 4, k=6, workflow_id="w4", storage=roots[p])
        with node.InputNode() as inp:
            s = r_add.bind(inp[0], inp.k)
            dag2 = node.MultiOutputNode([r_mul.bind(s, 2), r_mul.bind(s, 5)])
        out2 = wf.resume("w4", dag2, storage=roots[p])
        meta = wf.get_metadata("w4", storage=roots[p])
        seen[p] = (out, out2, meta["steps_restored"],
                   meta["steps_executed"], _steps(roots[p], "w4"))
    assert seen["port"] == seen["reference"]
    assert seen["port"][:4] == ([20, 30], [20, 50], 2, 1)
    assert len(seen["port"][4]) == 4


def test_run_async_delete_and_unknown_ids(ray_start, roots):
    def add(x, y):
        return x + y

    seen = {}
    for p, (remote, node, wf) in PACKAGES.items():
        r_add = remote(add)
        with node.InputNode() as inp:
            dag = r_add.bind(inp, 7)
        wid, fut = wf.run_async(dag, 1, workflow_id="w5", storage=roots[p])
        value = fut.result(timeout=60)
        status = _status_name(wf.get_status(wid, storage=roots[p]))
        wf.delete(wid, storage=roots[p])
        gone = (wf.get_status(wid, storage=roots[p]),
                wf.get_metadata(wid, storage=roots[p]),
                wf.list_all(storage=roots[p]))
        with pytest.raises(ValueError, match="no workflow"):
            wf.resume("missing", dag, storage=roots[p])
        with pytest.raises(ValueError, match="no output"):
            wf.get_output("missing", storage=roots[p])
        seen[p] = (wid, value, status, gone)
    assert seen["port"] == seen["reference"] == (
        "w5", 8, "SUCCESSFUL", (None, None, []))


def test_storage_root_from_the_environment(monkeypatch, tmp_path):
    def inc(x):
        return x + 1

    monkeypatch.setenv("RAY_TPU_WORKFLOW_STORAGE", str(tmp_path / "env"))
    r_inc = tactor.remote(inc)
    with tnode.InputNode() as inp:
        dag = r_inc.bind(inp)
    assert twf.run(dag, 1, workflow_id="w6") == 2
    wf_dir = tmp_path / "env" / "w6"
    assert sorted(os.listdir(wf_dir)) == ["input.pkl", "meta.json",
                                          "output.pkl", "steps"]
    assert twf.get_output("w6") == 2
    assert twf.list_all() == [("w6", twf.WorkflowStatus.SUCCESSFUL)]


def test_actor_step_is_refused(ray_start, roots):
    """A workflow runs function steps only: an actor-method node raises
    ``TypeError`` and leaves the workflow resumable, in both packages."""
    seen = {}
    for p, (_remote, node, wf) in PACKAGES.items():
        with node.InputNode() as inp:
            dag = node.ClassMethodNode(None, "step", (inp,), {})
        with pytest.raises(TypeError, match="function"):
            wf.run(dag, 1, workflow_id="w7", storage=roots[p])
        seen[p] = _status_name(wf.get_status("w7", storage=roots[p]))
    assert seen["port"] == seen["reference"] == "RESUMABLE"
