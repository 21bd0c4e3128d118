"""Internals shared by the port's channel plane: shm segments and the wire
format (counterparts of ``ray_tpu/_private/``)."""
