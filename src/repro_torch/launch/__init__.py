"""Launchers of the port: the serving steps and the split-serve CLI."""
