"""Launchers of the port: the step builders (prefill and serve so far)."""
