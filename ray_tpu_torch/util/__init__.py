"""Utilities of the port: the fault-injection registry
(counterpart of ``ray_tpu/util/``)."""
