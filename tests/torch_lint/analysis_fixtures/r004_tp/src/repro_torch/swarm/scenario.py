"""Registry with an untested, undocumented key (cf. DESIGN.md §42)."""


def ghost_walk(keys, cfg, n):
    return None


MOBILITY_MODELS = {
    "ghost_walk_model": ghost_walk,
}
