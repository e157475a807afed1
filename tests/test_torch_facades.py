"""The port's public surface against the JAX package's: every name of the
reference's package facades resolves on the port's counterpart.

One case per (package, name): the ``__all__`` of ``repro.core``,
``repro.sched``, ``repro.workloads``, ``repro.api``, ``repro.kernels`` and
``repro`` itself, and the public definitions of ``repro.configs`` and
``repro.train`` (which have no ``__all__``).  ``LATER`` lists the names
still to come, whose cases assert that they are absent; it is empty since
the training path brought ``repro.kernels.ref``.  Where the reference
keeps an order, the port's ``__all__`` lists the reference's names in it.
"""
import importlib
import importlib.util
import types

import pytest

PACKAGES = ("core", "sched", "workloads", "configs", "api", "kernels",
            "train", "")
#: (package, name) of the reference's surface that a later slice ports
LATER = {}


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


# --------------------------------------------------------------------------- #
# the launch tools                                                             #
# --------------------------------------------------------------------------- #
def _dryrun_public_names():
    """The reference dry run's public top-level names, read from its source:
    importing it sets XLA_FLAGS for 512 devices."""
    import ast
    import pathlib

    import repro
    src = pathlib.Path(repro.__file__).parent / "launch" / "dryrun.py"
    names = []
    for node in ast.parse(src.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.append(node.target.id)
    return [n for n in names if not n.startswith("_")]


def _launch_cases():
    cases = []
    for sub in ("mesh", "roofline", "shardings"):
        ref = importlib.import_module(f"repro.launch.{sub}")
        # the reference's shardings.__all__ names "ShardingPlan", which it
        # never defines (its plan class is Plan): only names that resolve
        cases += [(sub, n) for n in ref.__all__ if hasattr(ref, n)]
    return cases + [("dryrun", n) for n in _dryrun_public_names()]


LAUNCH_CASES = _launch_cases()


@pytest.mark.parametrize("sub,name", LAUNCH_CASES,
                         ids=[f"launch.{s}.{n}" for s, n in LAUNCH_CASES])
def test_reference_launch_name_resolves_on_the_port(sub, name):
    port = importlib.import_module(f"repro_torch.launch.{sub}")
    assert hasattr(port, name), f"repro_torch.launch.{sub}: {name!r}"


def test_launch_facade_holds_mesh_roofline_shardings_not_dryrun():
    """As the reference's ``launch/__init__.py``: the three modules, not
    the dry run (a fresh process, so that no other test's import shows)."""
    import subprocess
    import sys

    probe = ("import sys, repro_torch.launch as L; "
             "print(all(hasattr(L, m) for m in "
             "('mesh', 'roofline', 'shardings')), "
             "'repro_torch.launch.dryrun' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.split() == ["True", "False"]
    from repro.launch import shardings as ref_sh
    from repro_torch.launch import shardings
    assert "ShardingPlan" in ref_sh.__all__ and not hasattr(ref_sh,
                                                            "ShardingPlan")
    assert shardings.__all__[:2] == ["Plan", "make_plan"]
