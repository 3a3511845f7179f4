"""Swarm simulator: scenario models, queues, transfers and the epoch loop."""
