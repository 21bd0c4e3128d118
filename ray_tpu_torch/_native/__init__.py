"""Native (C++) components of the port, built on first use with ``g++``
(``build.py``): the channel data plane (``channel.cc``), the port's copy
of ``ray_tpu/_native/channel.cc``."""
