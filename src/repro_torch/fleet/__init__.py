"""Monte-Carlo batching of simulator runs."""
