"""Experimental APIs: the compiled-graph channel plane (``channel``)."""
