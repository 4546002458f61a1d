"""Launchers of the port: the prefill step and the LM serving loop."""
