"""Deployment definition + ``@serve.deployment`` decorator (counterpart of
``ray_tpu/serve/deployment.py``).

A replica is a process that imports its callable by reference
(``serve/replica.py``): the deployed class or function must live at a
module's top level, decorated there or not.  The reference's
``ray_actor_options={"num_tpus": n}`` becomes ``{"num_gpus": n}``: a
replica with ``num_gpus > 0`` is bound to a card of its own.  The
queue-depth autoscaler waits (ROADMAP), so a deployment takes no
``autoscaling_config``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 16
    # router-side admission bound: requests waiting for a replica slot
    # beyond this are shed with BackPressureError (503 at the proxy)
    # instead of queueing without limit behind a stalled replica; -1
    # disables the bound
    max_queued_requests: int = 128
    user_config: Optional[Dict[str, Any]] = None
    ray_actor_options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    graceful_shutdown_timeout_s: float = 10.0


class Deployment:
    def __init__(self, cls_or_fn: Any, name: str, config: DeploymentConfig,
                 route_prefix: Optional[str] = None):
        self._target = cls_or_fn
        self.name = name
        self.config = config
        self.route_prefix = route_prefix

    def options(self, *, num_replicas: Optional[int] = None,
                max_ongoing_requests: Optional[int] = None,
                max_queued_requests: Optional[int] = None,
                user_config: Optional[Dict[str, Any]] = None,
                ray_actor_options: Optional[Dict[str, Any]] = None,
                name: Optional[str] = None,
                route_prefix: Optional[str] = None) -> "Deployment":
        cfg = dataclasses.replace(self.config)
        if num_replicas is not None:
            cfg.num_replicas = num_replicas
        if max_ongoing_requests is not None:
            cfg.max_ongoing_requests = max_ongoing_requests
        if max_queued_requests is not None:
            cfg.max_queued_requests = max_queued_requests
        if user_config is not None:
            cfg.user_config = user_config
        if ray_actor_options is not None:
            cfg.ray_actor_options = ray_actor_options
        return Deployment(self._target, name or self.name, cfg,
                          route_prefix if route_prefix is not None
                          else self.route_prefix)

    def bind(self, *args, **kwargs) -> "Application":
        """Bind constructor args (possibly other Applications: composition)."""
        return Application(self, args, kwargs)

    def __repr__(self):
        return f"Deployment({self.name})"


class Application:
    """A bound deployment graph node."""

    def __init__(self, deployment: Deployment, args: Tuple, kwargs: Dict):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs

    def _collect(self) -> List["Application"]:
        """All applications in this graph, dependencies first."""
        seen: Dict[int, Application] = {}
        order: List[Application] = []

        def visit(app: Application):
            if id(app) in seen:
                return
            seen[id(app)] = app
            for a in list(app.args) + list(app.kwargs.values()):
                if isinstance(a, Application):
                    visit(a)
            order.append(app)

        visit(self)
        return order


def deployment(cls_or_fn: Any = None, *, name: Optional[str] = None,
               num_replicas: int = 1, max_ongoing_requests: int = 16,
               max_queued_requests: int = 128,
               user_config: Optional[Dict[str, Any]] = None,
               ray_actor_options: Optional[Dict[str, Any]] = None,
               route_prefix: Optional[str] = None):
    """``@serve.deployment``: wraps a class (or function) as a Deployment."""

    def wrap(target):
        cfg = DeploymentConfig(
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            max_queued_requests=max_queued_requests,
            user_config=user_config,
            ray_actor_options=ray_actor_options or {})
        return Deployment(target, name or getattr(target, "__name__", "app"),
                          cfg, route_prefix=route_prefix)

    if cls_or_fn is not None:
        return wrap(cls_or_fn)
    return wrap
