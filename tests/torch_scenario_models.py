"""Third-party scenario models for the checks of the public registry
(``register_mobility``, ``register_channel``, ``register_channel_edges``,
``register_fault``): tests/test_torch_scenarios.py and
tests/torch_scenario_dispatch.py on the CPU, ``chip_smoke.py`` phase 4c on
the card.  In both packages' contracts:

* toys written for the tests: ``toy_drift`` (a random walk on a 16,384-m
  square), ``toy_linear`` (pathloss linear in distance, 8 dB more on links
  whose end nodes' ids sum to an odd number; dense and per edge) and
  ``toy_flaky`` (each up node fails an epoch with probability 1/16, each
  down node recovers with probability 1/2).  ``port_toys()`` gives them
  batched over the runs on ``repro_torch.rng`` keys, ``reference_toys()``
  per run in ``jnp`` (jax is imported only there).  Their arithmetic
  scales by powers of two, so it rounds alike whether or not a compiler
  fuses a multiply into an add;
* ``port_aliases()``: the built-in ``circular``, ``two_ray`` (with
  ``two_ray_edges``) and ``markov`` callables under new names, which must
  give the built-in names' results bit for bit.

``register(swarm, models)`` registers ``models`` through a package's
public API (``repro_torch.swarm`` or ``repro.swarm``) and returns the
function that removes them again, for a fixture's teardown: the
registries are module state shared by every test a process runs.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

AREA = 16384.0            # the walk's square, metres (exact in float32)
STEP = 512.0              # a step is uniform in [-STEP/2, STEP/2) an axis
SLOPE = 1.0 / 128.0       # dB a metre
LOSS_EVEN, LOSS_ODD = 32.0, 40.0
P_FAIL, P_RECOVER = 1.0 / 16.0, 0.5

TOY = dict(mobility_model="toy_drift", channel_model="toy_linear",
           fault_model="toy_flaky")
ALIAS = dict(mobility_model="alias_circular", channel_model="alias_two_ray",
             fault_model="alias_markov")
BUILTIN = dict(mobility_model="circular", channel_model="two_ray",
               fault_model="markov")
REGISTRIES = {"mobility": "MOBILITY_MODELS", "channel": "CHANNEL_MODELS",
              "channel_edges": "CHANNEL_EDGE_MODELS",
              "fault": "FAULT_MODELS"}


def _models(cfg: Dict[str, str], mobility, channel, channel_edges, fault
            ) -> Dict[str, Tuple[str, Tuple[Callable, ...]]]:
    return {"mobility": (cfg["mobility_model"], mobility),
            "channel": (cfg["channel_model"], channel),
            "channel_edges": (cfg["channel_model"], channel_edges),
            "fault": (cfg["fault_model"], fault)}


def port_toys():
    import torch

    from repro_torch import rng

    def drift_init(keys, cfg, n):
        return {"pos": rng.uniform(keys, (n, 2)) * AREA}

    def drift_step(state, keys, cfg, t0):
        pos = state["pos"]
        step = (rng.uniform(keys, tuple(pos.shape[-2:])) - 0.5) * STEP
        return {"pos": torch.clamp(pos + step, 0.0, AREA)}, pos

    def loss(dist, pair):
        base = torch.where(pair % 2 == 1, LOSS_ODD, LOSS_EVEN)
        return dist * SLOPE + base.to(dist.dtype)

    def linear(keys, dist, cfg):
        idx = torch.arange(dist.shape[-1], device=dist.device)
        return loss(dist, idx[:, None] + idx[None, :])

    def linear_edges(keys, dist, src, dst, cfg):
        return loss(dist, src + dst)

    def flaky_init(keys, cfg, n):
        return torch.ones((keys.shape[0], n), dtype=torch.bool,
                          device=keys.device)

    def flaky_step(alive, keys, cfg):
        u = rng.uniform(keys, (alive.shape[-1],))
        return torch.where(alive, u >= P_FAIL, u < P_RECOVER)

    return _models(TOY, (drift_init, drift_step), (linear,),
                   (linear_edges,), (flaky_init, flaky_step))


def reference_toys():
    import jax
    import jax.numpy as jnp

    def drift_init(key, cfg, n):
        return {"pos": jax.random.uniform(key, (n, 2)) * AREA}

    def drift_step(state, key, cfg, t0):
        pos = state["pos"]
        step = (jax.random.uniform(key, pos.shape) - 0.5) * STEP
        return {"pos": jnp.clip(pos + step, 0.0, AREA)}, pos

    def loss(dist, pair):
        return dist * SLOPE + jnp.where(pair % 2 == 1, LOSS_ODD, LOSS_EVEN)

    def linear(key, dist, cfg):
        idx = jnp.arange(dist.shape[-1])
        return loss(dist, idx[:, None] + idx[None, :])

    def linear_edges(key, dist, src, dst, cfg):
        return loss(dist, src + dst)

    def flaky_init(key, cfg, n):
        return jnp.ones((n,), bool)

    def flaky_step(alive, key, cfg):
        u = jax.random.uniform(key, alive.shape)
        return jnp.where(alive, u >= P_FAIL, u < P_RECOVER)

    return _models(TOY, (drift_init, drift_step), (linear,),
                   (linear_edges,), (flaky_init, flaky_step))


def port_aliases():
    from repro_torch.swarm import channel, mobility, scenario
    markov = scenario.FAULT_MODELS["markov"]
    return _models(ALIAS, (mobility.init_mobility, mobility.step_circular),
                   (channel.two_ray,), (channel.two_ray_edges,),
                   tuple(markov))


def register(swarm, models) -> Callable[[], None]:
    """Registers ``models`` through ``swarm.register_*``; returns the undo."""
    for kind, (name, fns) in models.items():
        getattr(swarm, f"register_{kind}")(name, *fns)

    def undo():
        for kind, (name, _) in models.items():
            getattr(swarm, REGISTRIES[kind]).pop(name, None)
    return undo
