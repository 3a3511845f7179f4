"""A reference-side test: it is no evidence for the port."""


def test_ghost_walk_registered():
    assert "ghost_walk_model"
