"""The run's key-value store: ``put``/``get``/``delete``/``keys`` over one
``torch.distributed.TCPStore``.

It takes the place of the reference's GCS KV
(``ray_tpu.experimental.internal_kv``) for what the train and collective
tiers keep there: the run's status, collective rendezvous and member
status records, and the step ledger's breakdowns.  The train controller
hosts the store (:func:`host`) and passes its address to every worker in
``RAY_TPU_TORCH_KV``; a worker reaches it with :func:`client`.

A ``TCPStore`` cannot list its keys on every torch release the port
runs on, so :meth:`RunKV.put` appends each new key to an index key and
:meth:`RunKV.keys` reads the index back, keeping the keys still present.
"""

from __future__ import annotations

import datetime
import os
import threading
from typing import Dict, List, Optional, Tuple

import torch.distributed as dist

from ray_tpu_torch._private.net import LOOPBACK, address_in_use, free_port

ENV_KV = "RAY_TPU_TORCH_KV"  # "host:port" of the run's store
_INDEX = "__kv_index__"
# a reader blocks at most this long on a key deleted between its check
# and its read (the store's get waits for a missing key)
DEFAULT_TIMEOUT_S = 10.0


class RunKV:
    """A connection to the run's store."""

    def __init__(self, store: dist.TCPStore, addr: str):
        self.store = store
        self.addr = addr

    def put(self, key: str, value: bytes) -> None:
        if not self.store.check([key]):
            self.store.append(_INDEX, key + "\n")
        self.store.set(key, value)

    def get(self, key: str) -> Optional[bytes]:
        if not self.store.check([key]):
            return None
        try:
            return self.store.get(key)
        except RuntimeError:  # deleted after the check: the read timed out
            return None

    def delete(self, key: str) -> bool:
        return self.store.delete_key(key)

    def keys(self, prefix: str = "") -> List[str]:
        """The keys present that start with ``prefix``, in first-put
        order."""
        raw = self.get(_INDEX)
        if not raw:
            return []
        seen: Dict[str, None] = {}
        for k in raw.decode().splitlines():
            if k.startswith(prefix):
                seen.setdefault(k)
        return [k for k in seen if self.store.check([k])]


def _store(port: int, is_master: bool, timeout_s: float) -> dist.TCPStore:
    return dist.TCPStore(LOOPBACK, port, is_master=is_master,
                         wait_for_workers=False,
                         timeout=datetime.timedelta(seconds=timeout_s))


def host(timeout_s: float = DEFAULT_TIMEOUT_S) -> RunKV:
    """Host the run's store on a free loopback port (a port another
    process took first is retried once)."""
    try:
        port = free_port()
        store = _store(port, True, timeout_s)
    except RuntimeError as e:
        if not address_in_use(e):
            raise
        port = free_port()
        store = _store(port, True, timeout_s)
    return RunKV(store, f"{LOOPBACK}:{port}")


def connect(addr: str, timeout_s: float = DEFAULT_TIMEOUT_S) -> RunKV:
    """A new connection to the store at ``addr`` ("host:port")."""
    host_, port = addr.rsplit(":", 1)
    store = dist.TCPStore(host_, int(port), is_master=False,
                          timeout=datetime.timedelta(seconds=timeout_s))
    return RunKV(store, addr)


_clients: Dict[Tuple[str, int], RunKV] = {}
_clients_lock = threading.Lock()


def address() -> Optional[str]:
    """The run's store address from this process's environment, if any."""
    return os.environ.get(ENV_KV) or None


def client() -> RunKV:
    """This process's connection to the run's store (``RAY_TPU_TORCH_KV``),
    opened once per process."""
    addr = address()
    if addr is None:
        raise RuntimeError(
            f"no run key-value store: {ENV_KV} is not set (a TorchTrainer "
            "sets it in every worker; elsewhere host one with "
            "ray_tpu_torch._private.kv.host() and export its addr)")
    key = (addr, os.getpid())
    with _clients_lock:
        kv = _clients.get(key)
        if kv is None:
            kv = _clients[key] = connect(addr)
        return kv
