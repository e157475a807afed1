"""The port's public surface against the JAX package's: every name of the
reference's package facades resolves on the port's counterpart.

One case per (package, name): the ``__all__`` of ``repro.core``,
``repro.sched``, ``repro.workloads``, ``repro.api``, ``repro.kernels`` and
``repro`` itself, and the public definitions of ``repro.configs`` and
``repro.train`` (which have no ``__all__``).  ``LATER`` lists the names
still to come, whose cases assert that they are absent; it is empty since
the training path brought ``repro.kernels.ref``.  Where the reference
keeps an order, the port's ``__all__`` lists the reference's names in it.

At module level, one case per (module, name) of the reference's public
names of ``kernels.alloc_matvec``, ``kernels.flash_attention``,
``kernels.rglru_scan``, ``kernels.rwkv6_scan``, ``kernels.ops``,
``models.layers`` and ``workloads.registry``; ``DELIBERATE`` lists the
names the port leaves out on purpose (ROADMAP §3), whose cases assert
that they are absent.  The kernel modules' entries under the reference's
names are held against its Pallas kernels in interpret mode on the CPU,
at its own tests' tolerances (``tests/test_kernels.py``).
"""
import importlib
import importlib.util
import types

import numpy as np
import pytest
import torch

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


# --------------------------------------------------------------------------- #
# module level                                                                #
# --------------------------------------------------------------------------- #
MODULES = ("kernels.alloc_matvec", "kernels.flash_attention",
           "kernels.rglru_scan", "kernels.rwkv6_scan", "kernels.ops",
           "models.layers", "workloads.registry")
#: (module, name) of the reference's that the port leaves out on purpose
DELIBERATE = {
    ("kernels.ops", "set_backend"):
        "the device of the data picks the version: no process-wide switch",
    ("kernels.ops", "get_backend"):
        "the device of the data picks the version: no process-wide switch"}
MODULE_CASES = [(m, n) for m in MODULES
                for n in _public(importlib.import_module("repro." + m))]


@pytest.mark.parametrize("mod,name", MODULE_CASES,
                         ids=[f"{m}.{n}" for m, n in MODULE_CASES])
def test_reference_module_name_resolves_on_the_port(mod, name):
    port = importlib.import_module("repro_torch." + mod)
    if (mod, name) in DELIBERATE:
        assert not hasattr(port, name), DELIBERATE[(mod, name)]
        return
    assert hasattr(port, name), f"repro_torch.{mod}: {name!r} is missing"


@pytest.mark.parametrize("mod", [m for m in MODULES if hasattr(
    importlib.import_module("repro." + m), "__all__")])
def test_port_module_all_holds_the_reference_names(mod):
    ref = importlib.import_module("repro." + mod).__all__
    port = importlib.import_module("repro_torch." + mod)
    assert set(ref) <= set(port.__all__)
    assert len(set(port.__all__)) == len(port.__all__)
    space = {}
    exec(f"from {port.__name__} import *", space)      # noqa: S102
    assert all(n in space for n in port.__all__)


def test_workload_kinds_is_the_live_registry():
    from repro.workloads import registry as ref
    from repro_torch.workloads import registry
    space = {}
    exec("from repro_torch.workloads.registry import *", space)  # noqa: S102
    assert space["WORKLOAD_KINDS"] == tuple(registry.list_workloads())
    assert set(ref.WORKLOAD_KINDS) <= set(space["WORKLOAD_KINDS"])


def _rand(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def test_alloc_matvec_names_equal_the_reference_bit_for_bit():
    import jax
    from repro.kernels import alloc_matvec as ref

    from repro_torch.kernels import alloc_matvec as port
    rng = np.random.default_rng(7)
    weight = rng.random((3, 10, 37)) * (rng.random((3, 10, 37)) < 0.4)
    x = rng.random((3, 37))
    with jax.enable_x64(True):
        want = np.asarray(ref.alloc_matvec(weight, x, interpret=True))
        want_ref = np.asarray(ref.alloc_matvec_ref(weight, x))
    got = port.alloc_matvec(weight, x, interpret=True)
    assert got.dtype == torch.float64
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(port.alloc_matvec_ref(weight, x).numpy(), want_ref)


@pytest.mark.parametrize("causal,window,Tq,Tk", [(True, 0, 128, 128),
                                                 (True, 32, 128, 128),
                                                 (False, 0, 64, 192)])
def test_flash_attention_name_matches_the_reference(causal, window, Tq, Tk):
    import jax.numpy as jnp
    from repro.kernels import flash_attention as ref

    from repro_torch.kernels import flash_attention as port
    q, k, v = (_rand(i, s) for i, s in enumerate(
        [(2, Tq, 4, 32), (2, Tk, 2, 32), (2, Tk, 2, 32)]))
    off = Tk - Tq if causal else 0
    want = ref.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                               causal=causal, window=window, q_offset=off,
                               block_q=64, block_k=64, interpret=True)
    got = port.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=causal, window=window, q_offset=off,
                               block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_flash_decode_name_matches_the_reference():
    import jax.numpy as jnp
    from repro.kernels import flash_attention as ref

    from repro_torch.kernels import flash_attention as port
    q, k, v = _rand(10, (3, 8, 64)), _rand(11, (3, 256, 2, 64)), \
        _rand(12, (3, 256, 2, 64))
    lens = np.array([10, 100, 255], np.int32)
    want = ref.flash_decode(*(jnp.asarray(a) for a in (q, k, v)),
                            jnp.asarray(lens), block_k=64, interpret=True)
    got = port.flash_decode(*(torch.from_numpy(a) for a in (q, k, v)),
                            torch.from_numpy(lens), block_k=64,
                            interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_wkv6_name_matches_the_reference():
    import jax.numpy as jnp
    from repro.kernels import rwkv6_scan as ref

    from repro_torch.kernels import rwkv6_scan as port
    B, T, H, dk, dv = 1, 64, 2, 32, 32
    r, k, v = (0.5 * _rand(20 + i, (B, T, H, d))
               for i, d in enumerate((dk, dk, dv)))
    w = (0.5 / (1.0 + np.exp(-_rand(23, (B, T, H, dk)))) + 0.45).astype(
        np.float32)
    u, s0 = 0.5 * _rand(24, (H, dk)), 0.1 * _rand(25, (B, H, dk, dv))
    args = (r, k, v, w, u, s0)
    y_want, s_want = ref.wkv6(*(jnp.asarray(a) for a in args), block_t=32,
                              interpret=True)
    y, sT = port.wkv6(*(torch.from_numpy(a) for a in args), block_t=32,
                      interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(sT.numpy(), np.asarray(s_want), atol=1e-4,
                               rtol=1e-4)


def test_split_tree_splits_a_generator_into_independent_streams():
    from repro_torch.models.layers import split_tree, uinit
    gens = split_tree(torch.Generator().manual_seed(4), 3)
    again = split_tree(torch.Generator().manual_seed(4), 3)
    assert len(gens) == 3
    draws = [uinit(g, (8, 8), None, torch.float32, "cpu") for g in gens]
    assert all(torch.equal(d, uinit(g, (8, 8), None, torch.float32, "cpu"))
               for d, g in zip(draws, again))
    assert not torch.equal(draws[0], draws[1])
