"""The port stands alone: ``ray_tpu_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of ``ray_tpu``, nor ``pyarrow``, ``pandas``
or ``aiohttp`` (the card's machine has none of them), and the port lints
clean."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, dirnames, files in os.walk(os.path.join(REPO,
                                                         "ray_tpu_torch")):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__",
                                                        "build")]
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "orbax", "pyarrow",
                   "pandas", "aiohttp") or top == "ray_tpu"


def test_port_sources_exist():
    srcs = _port_sources()
    assert os.path.exists(srcs[0]), "chip_smoke.py is missing"
    assert len(srcs) >= 10


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_serving_front_sources_are_covered():
    """The serving front's modules are among the sources checked for
    jax, ``ray_tpu`` and aiohttp imports (the card's machine has no
    aiohttp: the proxy is the standard library's)."""
    rel = {os.path.relpath(p, REPO) for p in _port_sources()}
    want = {f"ray_tpu_torch/serve/{m}.py" for m in (
        "__init__", "_wire", "context", "controller", "deployment", "proxy",
        "replica", "router")}
    want |= {"ray_tpu_torch/llm/serving.py", "ray_tpu_torch/llm/batch.py"}
    assert want <= rel, sorted(want - rel)


def test_dag_sources_are_covered():
    """The compiled-graph DAG's modules, the process actors and the
    channel plane's communicators are among the sources checked for jax
    and ``ray_tpu`` imports."""
    rel = {os.path.relpath(p, REPO) for p in _port_sources()}
    want = {f"ray_tpu_torch/dag/{m}.py" for m in (
        "__init__", "dag_node", "interpreter", "collective_node",
        "compiled_dag", "pipeline_schedule")}
    want |= {"ray_tpu_torch/actor.py",
             "ray_tpu_torch/experimental/channel/communicator.py",
             "ray_tpu_torch/util/collective/collective.py"}
    assert want <= rel, sorted(want - rel)


def test_import_leaves_jax_and_reference_unloaded():
    code = (
        "import sys\n"
        "import ray_tpu_torch, ray_tpu_torch.llm.engine, "
        "ray_tpu_torch.models.convert, ray_tpu_torch.models.training, "
        "ray_tpu_torch.ops.cuda._build, "
        "ray_tpu_torch.ops.cuda.flash_attention, "
        "ray_tpu_torch.ops.cuda.remote_copy, "
        "ray_tpu_torch._private.shm, ray_tpu_torch._private.serialization, "
        "ray_tpu_torch.experimental, ray_tpu_torch.experimental.channel, "
        "ray_tpu_torch.experimental.channel.shared_memory_channel, "
        "ray_tpu_torch.experimental.channel.transport, "
        "ray_tpu_torch.llm.kv_transfer, ray_tpu_torch.util.fault_injection, "
        "ray_tpu_torch.parallel, ray_tpu_torch.parallel.mesh, "
        "ray_tpu_torch.parallel.sharding, ray_tpu_torch.parallel.pipeline, "
        "ray_tpu_torch.exceptions, ray_tpu_torch._private.accelerators, "
        "ray_tpu_torch._private.net, ray_tpu_torch._private.kv, "
        "ray_tpu_torch._private.durations, ray_tpu_torch.util.collective, "
        "ray_tpu_torch.util.collective.types, "
        "ray_tpu_torch.util.collective.collective, "
        "ray_tpu_torch.util.collective.supervision, "
        "ray_tpu_torch.util.collective.collective_group.base_collective_group, "
        "ray_tpu_torch.util.collective.collective_group.torch_group, "
        "ray_tpu_torch.train, ray_tpu_torch.train.config, "
        "ray_tpu_torch.train.policies, ray_tpu_torch.train.checkpoint, "
        "ray_tpu_torch.train.checkpoint_manager, "
        "ray_tpu_torch.train.worker_group, ray_tpu_torch.train.session, "
        "ray_tpu_torch.train.controller, ray_tpu_torch.train.trainer, "
        "ray_tpu_torch.models.vit, ray_tpu_torch.util.health, "
        "ray_tpu_torch._private.health_plane, "
        "ray_tpu_torch._private.node_faults, "
        "ray_tpu_torch._private.concurrency, ray_tpu_torch.data, "
        "ray_tpu_torch.data.context, ray_tpu_torch.data.block, "
        "ray_tpu_torch.data._tasks, ray_tpu_torch.data.transforms, "
        "ray_tpu_torch.data.logical, ray_tpu_torch.data.planner, "
        "ray_tpu_torch.data.operators, "
        "ray_tpu_torch.data.streaming_executor, "
        "ray_tpu_torch.data.datasource, ray_tpu_torch.data.iterator, "
        "ray_tpu_torch.data.dataset, ray_tpu_torch.serve, "
        "ray_tpu_torch.serve.context, ray_tpu_torch.serve.deployment, "
        "ray_tpu_torch.serve._wire, ray_tpu_torch.serve.replica, "
        "ray_tpu_torch.serve.controller, ray_tpu_torch.serve.router, "
        "ray_tpu_torch.serve.proxy, ray_tpu_torch.llm.serving, "
        "ray_tpu_torch.llm.batch, ray_tpu_torch._private.config, "
        "ray_tpu_torch._private.resilience, "
        "ray_tpu_torch.train.checkpoint_async, "
        "ray_tpu_torch.util.checkpoint_replica, "
        "ray_tpu_torch.rl.weight_sync, ray_tpu_torch.rl.rlhf, "
        "ray_tpu_torch.actor, ray_tpu_torch.dag, "
        "ray_tpu_torch.dag.dag_node, ray_tpu_torch.dag.interpreter, "
        "ray_tpu_torch.dag.collective_node, ray_tpu_torch.dag.compiled_dag, "
        "ray_tpu_torch.dag.pipeline_schedule, "
        "ray_tpu_torch.experimental.channel.communicator\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ray_tpu', 'pyarrow', 'pandas', 'aiohttp'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_lints_clean():
    """raylint over the port, every rule on.  The fault-site rule looks
    for its registry at the reference's path, so that module is scanned
    beside the port: each ``fault_point`` site of the port must then be
    documented where the rule looks (``docs/fault_tolerance.md`` and the
    reference registry's table) and, checked here, in the site table of
    the port's own registry, ``ray_tpu_torch/util/fault_injection.py``."""
    from ray_tpu._private.analysis.checkers.fault_sites import _sites
    from ray_tpu._private.analysis.core import (Project, _collect_files,
                                                run_lint)

    registry = "ray_tpu/util/fault_injection.py"
    result = run_lint(REPO, paths=["ray_tpu_torch", registry])
    assert result.files_scanned >= 10
    assert not result.findings, "\n".join(f.render()
                                          for f in result.findings)
    port = Project(REPO, _collect_files(REPO, ["ray_tpu_torch"]))
    sites = _sites(port)
    assert "llm.kv_ship" in sites
    doc = ast.get_docstring(
        port.file("ray_tpu_torch/util/fault_injection.py").tree)
    assert [s for s in sites if f"``{s}``" not in doc] == []


RL_MODULES = ("_respawn", "env", "models", "ppo", "env_runner", "algorithm",
              "impala", "dqn", "sac", "bc", "cql", "multi_agent_env",
              "multi_agent_ppo", "dreamer", "convert", "weight_sync", "rlhf",
              "__init__")


def test_rl_sources_are_covered():
    """The RL package's modules are among the sources checked for jax,
    optax and ``ray_tpu`` imports."""
    rel = {os.path.relpath(p, REPO) for p in _port_sources()}
    want = {f"ray_tpu_torch/rl/{m}.py" for m in RL_MODULES}
    assert want <= rel, sorted(want - rel)


def test_rl_import_leaves_jax_optax_and_gymnasium_unloaded():
    """``ray_tpu_torch.rl`` and each of its modules import in a fresh
    interpreter without loading jax, optax, ``ray_tpu`` or gymnasium
    (gymnasium is imported only by ``GymVectorEnv``, as the
    reference's)."""
    mods = ", ".join(f"ray_tpu_torch.rl.{m}" for m in RL_MODULES
                     if m != "__init__")
    code = (
        "import sys\n"
        f"import ray_tpu_torch.rl, {mods}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'ray_tpu', 'gymnasium'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_tiered_plane_sources_are_covered():
    """The tiered checkpoint plane, the weight sync and the RLHF loop are
    among the sources checked for jax, ``ray_tpu``, pyarrow, pandas and
    aiohttp imports (and linted by ``test_port_lints_clean``)."""
    rel = {os.path.relpath(p, REPO) for p in _port_sources()}
    want = {"ray_tpu_torch/train/checkpoint_async.py",
            "ray_tpu_torch/util/checkpoint_replica.py",
            "ray_tpu_torch/_private/resilience.py",
            "ray_tpu_torch/_private/config.py",
            "ray_tpu_torch/rl/weight_sync.py", "ray_tpu_torch/rl/rlhf.py"}
    assert want <= rel, sorted(want - rel)


MESH_AND_ANALOGUE_MODULES = (
    "ray_tpu_torch.util.collective.collective_group.mesh_group",
    "ray_tpu_torch.parallel.redistributes", "ray_tpu_torch.parallel.overlap",
    "ray_tpu_torch._private.accelerators")


def test_mesh_group_and_tpu_analogue_sources_are_covered():
    """The single-process multi-card group and the TPU-only pieces'
    counterparts are among the sources checked for jax and ``ray_tpu``
    imports."""
    rel = {os.path.relpath(p, REPO) for p in _port_sources()}
    want = {m.replace(".", "/") + ".py" for m in MESH_AND_ANALOGUE_MODULES}
    assert want <= rel, sorted(want - rel)


def test_mesh_group_import_leaves_jax_and_reference_unloaded():
    code = (
        "import sys\n"
        f"import {', '.join(MESH_AND_ANALOGUE_MODULES)}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ray_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
