"""Evidence that the registry keys are exercised by the port's tests."""


def test_ghost_walk_registered():
    assert "ghost_walk_model"


def test_strategy_names():
    assert ("LocalOnly", "Distributed")
