"""Record vocabulary of the port: the numpy half of ``repro.trace``."""
