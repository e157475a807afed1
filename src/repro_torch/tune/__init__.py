"""Online what-if autotuning: fork-race-promote policy search.

An :class:`AutoTuner` periodically forks the live
:class:`~repro_torch.sched.session.SimSession` (via ``snapshot()``), races a
portfolio of policy/period variants over a bounded sim-time horizon with
successive halving (:mod:`~repro_torch.tune.race`), scores the survivors
with a pluggable objective (:mod:`~repro_torch.tune.score`), and hot-swaps
the winner into the running session (:meth:`SimSession.switch_policy`) —
but only on a decisive margin after a minimum dwell, so the live policy
never flip-flops.  The races run where the session allocates: in lockstep
on its device, or on the host numpy path.  Tuner RNG, schedule and
decision log ride session snapshots bit-exactly, in the JAX package's
format.
"""
from .controller import AutoTuner, TuneConfig, parse_tune
from .race import RaceResult, Variant, race
from .score import Objective, list_objectives, parse_objective

__all__ = [
    "AutoTuner",
    "TuneConfig",
    "parse_tune",
    "RaceResult",
    "Variant",
    "race",
    "Objective",
    "list_objectives",
    "parse_objective",
]
