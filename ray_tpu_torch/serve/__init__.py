"""ray_tpu_torch.serve: online model serving (counterpart of
``ray_tpu.serve``).

``serve.run(app)`` deploys a bound deployment graph behind this process's
controller (a thread; ``serve/controller.py``), each replica a process of
its own (``serve/replica.py``); ``DeploymentHandle.remote()`` routes by
power-of-two choices; an optional HTTP proxy on the standard library
exposes route prefixes (``serve.start(http_options=...)``).

Quick use::

    from ray_tpu_torch import serve

    @serve.deployment
    class Echo:                 # at a module's top level
        def __call__(self, body):
            return body

    proxy = serve.start(http_options={"host": "127.0.0.1", "port": 0})
    handle = serve.run(Echo.bind(), route_prefix="/echo")
    handle.remote({"x": 1}).result(timeout=30)
    # curl -d '{"x": 1}' http://127.0.0.1:<proxy.port>/echo
    serve.shutdown()

Not ported yet (ROADMAP): the gRPC proxy, multiplexed model routing, the
engine-signal pool autoscaler and drain migration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from ray_tpu_torch.serve import context
from ray_tpu_torch.serve.context import (ReplicaContext, RequestContext,
                                         get_replica_context, request_scope)
from ray_tpu_torch.serve.deployment import (Application, Deployment,
                                            DeploymentConfig, deployment)
from ray_tpu_torch.serve.replica import batch
from ray_tpu_torch.serve.router import (DeploymentHandle, DeploymentResponse,
                                        DeploymentStreamingResponse,
                                        TwoStageHandle)

__all__ = [
    "Application", "Deployment", "DeploymentConfig", "DeploymentHandle",
    "DeploymentResponse", "DeploymentStreamingResponse", "ReplicaContext",
    "RequestContext", "TwoStageHandle", "batch", "context", "delete",
    "deployment", "get_app_handle", "get_deployment_handle",
    "get_replica_context", "request_scope", "run", "shutdown", "start",
    "status",
]

_proxy = None


def start(http_options: Optional[Dict[str, Any]] = None):
    """Start serve in this process: the controller and, with
    ``http_options`` (``host``, ``port`` (0: any free one),
    ``request_timeout_s``, ``max_concurrent_requests``), the HTTP proxy,
    which is returned (its bound port is ``.port``)."""
    from ray_tpu_torch.serve.controller import get_controller

    get_controller()
    global _proxy
    if http_options and _proxy is None:
        from ray_tpu_torch.serve.proxy import HTTPProxy

        _proxy = HTTPProxy(
            http_options.get("host", "127.0.0.1"),
            http_options.get("port", 8000),
            http_options.get("request_timeout_s", 120.0),
            http_options.get("max_concurrent_requests", 256))
    return _proxy


def run(target, *, name: str = "default",
        route_prefix: Optional[str] = "/") -> DeploymentHandle:
    """Deploy an application graph and return its ingress handle.  Every
    deployment's replicas start together; this returns once all are
    ready, and raises with a replica's traceback (after deleting what it
    deployed) if one cannot start."""
    from ray_tpu_torch.serve.controller import get_controller

    if isinstance(target, Deployment):
        target = target.bind()
    if not isinstance(target, Application):
        raise TypeError("serve.run expects a Deployment or bound Application")
    controller = get_controller()
    apps = target._collect()  # dependencies first
    handles: Dict[int, DeploymentHandle] = {}
    names: List[str] = []
    try:
        for app in apps:
            dep = app.deployment
            # Application args become handles to the deployed dependency
            init_args = tuple(handles[id(a)] if isinstance(a, Application)
                              else a for a in app.args)
            init_kwargs = {k: handles[id(v)] if isinstance(v, Application)
                           else v for k, v in app.kwargs.items()}
            is_ingress = app is apps[-1]
            prefix = (dep.route_prefix or route_prefix) if is_ingress \
                else None
            names.append(dep.name)
            controller.deploy(dep.name, dep._target, init_args, init_kwargs,
                              dataclasses.asdict(dep.config), prefix,
                              name if is_ingress else None)
            handles[id(app)] = DeploymentHandle(dep.name)
        controller.wait_ready(names)
    except BaseException:
        for n in names:
            controller.delete_deployment(n)
        raise
    return handles[id(apps[-1])]


def get_deployment_handle(deployment_name: str,
                          app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(deployment_name)


def get_app_handle(name: str = "default") -> DeploymentHandle:
    import json

    from ray_tpu_torch.serve.controller import APPS_KEY, serve_store

    raw = serve_store().get(APPS_KEY)
    ingress = json.loads(raw).get(name) if raw else None
    if ingress is None:
        raise RuntimeError(f"no application named {name!r}")
    return DeploymentHandle(ingress)


def status() -> Dict[str, Any]:
    """Every deployment's replicas, goal, version and overload counters
    (in the process that runs serve)."""
    from ray_tpu_torch.serve.controller import get_controller

    controller = get_controller(create=False)
    return {} if controller is None else controller.list_deployments()


def delete(deployment_name: str) -> None:
    from ray_tpu_torch.serve.controller import get_controller

    controller = get_controller(create=False)
    if controller is not None:
        controller.delete_deployment(deployment_name)
    with DeploymentHandle._routers_lock:
        DeploymentHandle._routers.pop(deployment_name, None)


def shutdown() -> None:
    """Stop every replica (each callable's ``__del__`` runs), the proxy
    and the controller; drop this process's routers."""
    global _proxy
    from ray_tpu_torch.serve.controller import _drop_controller

    controller = _drop_controller()
    if controller is not None:
        controller.shutdown()
    if _proxy is not None:
        _proxy.shutdown()
        _proxy = None
    with DeploymentHandle._routers_lock:
        DeploymentHandle._routers.clear()
