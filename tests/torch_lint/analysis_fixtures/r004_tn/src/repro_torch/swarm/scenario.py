"""Registry whose keys are tested and documented (DESIGN.md §4)."""

STRATEGY_NAMES = ("LocalOnly", "Distributed")


def ghost_walk(keys, cfg, n):
    return None


MOBILITY_MODELS = {
    "ghost_walk_model": ghost_walk,
}
