"""The port's public surface against the JAX package's: every name of the
reference's package facades resolves on the port's counterpart.

One case per (package, name): the ``__all__`` of ``repro.core``,
``repro.sched``, ``repro.workloads``, ``repro.api``, ``repro.kernels`` and
``repro`` itself, and the public definitions of ``repro.configs`` (which
has no ``__all__``).  The one name still to come is ``repro.kernels.ref``,
the kernels' pure-jnp oracles, which comes with the training path: its
case asserts that it is absent.  Where the reference keeps an order, the
port's ``__all__`` lists the reference's names in it.
"""
import importlib
import importlib.util
import types

import pytest

PACKAGES = ("core", "sched", "workloads", "configs", "api", "kernels", "")
#: (package, name) of the reference's surface that a later slice ports
LATER = {("kernels", "ref"): "the kernels' jnp oracles come with the "
                             "training path (ROADMAP.md)"}


def _module(root, pkg):
    return importlib.import_module(root + ("." + pkg if pkg else ""))


def _public(mod):
    """A module's ``__all__``, or its public names that are not modules or
    typing / dataclass helpers."""
    names = getattr(mod, "__all__", None)
    if names is not None:
        return list(names)
    return [n for n, v in vars(mod).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)
            and getattr(v, "__module__", None) not in (
                "typing", "dataclasses", "__future__")]


CASES = [(pkg, name) for pkg in PACKAGES
         for name in _public(_module("repro", pkg))]


def _resolves(mod, name):
    """The name is an attribute of the module, or a submodule of it."""
    if hasattr(mod, name):
        return True
    return (hasattr(mod, "__path__") and importlib.util.find_spec(
        f"{mod.__name__}.{name}") is not None)


@pytest.mark.parametrize("pkg,name", CASES,
                         ids=[f"{p or 'repro'}.{n}" for p, n in CASES])
def test_reference_name_resolves_on_the_port(pkg, name):
    port = _module("repro_torch", pkg)
    if (pkg, name) in LATER:
        assert not _resolves(port, name), LATER[(pkg, name)]
        return
    assert _resolves(port, name), \
        f"repro_torch.{pkg}: {name!r} is missing" if pkg else name


@pytest.mark.parametrize("pkg", ["core", "sched", "workloads", "api"])
def test_port_all_keeps_the_reference_order(pkg):
    ref = _module("repro", pkg).__all__
    port = _module("repro_torch", pkg).__all__
    assert [n for n in port if n in ref] == list(ref)
    assert len(set(port)) == len(port)


@pytest.mark.parametrize("pkg", ["core", "sched", "workloads", "configs",
                                 "api"])
def test_port_all_resolves_and_star_imports(pkg):
    mod = _module("repro_torch", pkg)
    space = {}
    exec(f"from {mod.__name__} import *", space)      # noqa: S102
    assert all(n in space for n in mod.__all__)


def test_facades_reexport_the_submodules_objects():
    from repro_torch import core, sched, workloads
    from repro_torch.core import job, yield_alloc
    from repro_torch.sched import engine
    from repro_torch.workloads import lublin, registry
    assert core.JobState is job.JobState
    assert core.min_yield is yield_alloc.min_yield
    assert sched.make_seed_policy is engine.make_seed_policy
    assert workloads.lublin_trace is lublin.lublin_trace
    assert workloads.WorkloadSpec is registry.WorkloadSpec


def test_the_library_line_runs():
    """The README's library line through the port's facades (on the CPU),
    equal to the reference's."""
    from conftest import result_dict
    from repro.sched import SimParams as RefParams, simulate as ref_simulate
    from repro.workloads import lublin_trace as ref_lublin

    from repro_torch.sched import SimParams, simulate
    from repro_torch.workloads import WorkloadSpec, lublin_trace
    r = simulate(lublin_trace(30, 16, seed=0), "GreedyP */OPT=MIN",
                 SimParams(n_nodes=16), device="cpu")
    want = ref_simulate(ref_lublin(30, 16, seed=0), "GreedyP */OPT=MIN",
                        RefParams(n_nodes=16))
    assert result_dict(r) == result_dict(want)
    assert WorkloadSpec("lublin", n_jobs=30, n_nodes=16).kind == "lublin"
