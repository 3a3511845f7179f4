"""Serving telemetry of the port: the numpy half of ``repro.obs``."""
