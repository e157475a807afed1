"""The port's public surface against the JAX package's: every module of the
reference (as ``pkgutil.walk_packages`` finds it), every public name of
each, and every public member of every class those names export, resolves
on the port's counterpart.

One case per (package, name): the ``__all__`` of ``repro.core``,
``repro.sched``, ``repro.workloads``, ``repro.api``, ``repro.kernels`` and
``repro`` itself, and the public definitions of ``repro.configs`` and
``repro.train`` (which have no ``__all__``).  ``LATER`` lists the names
still to come, whose cases assert that they are absent; it is empty since
the training path brought ``repro.kernels.ref``.  Where the reference
keeps an order, the port's ``__all__`` lists the reference's names in it.

One case per (module, name) of every other module of the reference: its
``__all__``, or else its public names that are not modules or typing /
dataclass helpers (``_public``).  ``core.alloc_jax`` maps to
``core.alloc_torch`` through ``RENAMES``.  The launch tools' modules
have cases of their own; the reference's ``launch.dryrun`` sets
``XLA_FLAGS`` for 512 host devices when it is imported, so its names are
read from its source with ``ast`` and it is never imported here.

One case per (class, member): every public member (``dir``, no leading
``_``) of every class defined in ``repro`` that those names export, on the
port's class of the same name.

``DELIBERATE`` lists the names and members the port leaves out on purpose
(ROADMAP §3), each with its reason; their cases assert that they are
absent.  The kernel modules' entries under the reference's names are held
against its Pallas kernels in interpret mode on the CPU, at its own tests'
tolerances (``tests/test_kernels.py``).
"""
import ast
import importlib
import importlib.util
import inspect
import pathlib
import pkgutil
import types

import numpy as np
import pytest
import torch

import repro

PACKAGES = ("core", "sched", "workloads", "configs", "api", "kernels",
            "train", "")
#: (package, name) of the reference's surface that a later slice ports
LATER = {}


def _module(root, pkg):
    return importlib.import_module(root + ("." + pkg if pkg else ""))


def _kept(value):
    """Not a module, nor a typing / dataclass helper."""
    return not isinstance(value, types.ModuleType) and getattr(
        value, "__module__", None) not in ("typing", "dataclasses",
                                           "__future__")


def _public(mod):
    """A module's ``__all__``, or its public names that :func:`_kept`
    keeps."""
    names = getattr(mod, "__all__", None)
    if names is not None:
        return list(names)
    return [n for n, v in vars(mod).items()
            if not n.startswith("_") and _kept(v)]


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
def _dryrun_surface():
    """The reference dry run's public top-level names, with the object each
    imported name binds (None for its own definitions, none of which is a
    class), read from its source: importing it sets XLA_FLAGS for 512
    devices.  Imported names pass ``_public``'s filter, as they would in
    ``vars()`` of the imported module."""
    src = pathlib.Path(repro.__file__).parent / "launch" / "dryrun.py"
    names = {}
    for node in ast.parse(src.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names[node.name] = None
        elif isinstance(node, ast.Assign):
            names.update((t.id, None) for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names[node.target.id] = None
        elif isinstance(node, ast.ImportFrom) and node.module != "__future__":
            src_mod = importlib.import_module(
                "." * node.level + (node.module or ""), "repro.launch")
            for alias in node.names:
                value = getattr(src_mod, alias.name)
                if _kept(value):
                    names[alias.asname or alias.name] = value
    return {n: v for n, v in names.items() if not n.startswith("_")}


LAUNCH_SUBS = ("mesh", "roofline", "shardings")
DRYRUN = _dryrun_surface()


def _launch_cases():
    cases = []
    for sub in LAUNCH_SUBS:
        cases += [(sub, n) for n in
                  importlib.import_module(f"repro.launch.{sub}").__all__]
    return cases + [("dryrun", n) for n in DRYRUN]


LAUNCH_CASES = _launch_cases()


@pytest.mark.parametrize("sub,name", LAUNCH_CASES,
                         ids=[f"launch.{s}.{n}" for s, n in LAUNCH_CASES])
def test_reference_launch_name_resolves_on_the_port(sub, name):
    port = importlib.import_module(f"repro_torch.launch.{sub}")
    if (f"launch.{sub}", name) in DELIBERATE:
        assert not hasattr(port, name), DELIBERATE[(f"launch.{sub}", name)]
        return
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
#: every module of the reference but the package facades above and the
#: launch tools, found as pkgutil walks the package
MODULES = tuple(
    info.name[len("repro."):]
    for info in pkgutil.walk_packages(repro.__path__, "repro.")
    if info.name[len("repro."):] not in PACKAGES
    and info.name[len("repro."):] not in tuple(
        f"launch.{sub}" for sub in LAUNCH_SUBS + ("dryrun",)))
#: the reference module whose port has another name, and its renamed names
PORT_MODULES = {"core.alloc_jax": "core.alloc_torch"}
RENAMES = {
    ("core.alloc_jax", "BatchedAllocator"): "TorchBatchedAllocator",
    ("core.alloc_jax", "JaxAllocBackend"): "TorchAllocBackend",
    ("core.alloc_jax", "maxmin_yields_jax"): "maxmin_yields_torch"}
_XLA_ONLY = ("steers only XLA's partitioner and scan; the port's dry run "
             "reads the same decisions from its Plan")
_NO_JAX = "the port imports torch, never jax"
#: (module, name) and (module, "Class.member") of the reference's that the
#: port leaves out on purpose, each with its reason
DELIBERATE = {
    ("kernels.ops", "set_backend"):
        "the device of the data picks the version: no process-wide switch",
    ("kernels.ops", "get_backend"):
        "the device of the data picks the version: no process-wide switch",
    ("core.alloc_jax", "has_jax"): _NO_JAX,
    ("models.backbone", "set_act_spec"): _XLA_ONLY,
    ("models.backbone", "set_ep_spec"): _XLA_ONLY,
    ("models.backbone", "set_unroll"): _XLA_ONLY,
    ("launch.shardings", "ShardingPlan"):
        "named in the reference's __all__ but never defined there: its plan "
        "class is Plan",
    ("launch.shardings", "Plan.shard"):
        "it returns jax NamedShardings; the port's Plan is a layout "
        "(local_shape, device_bytes)",
    ("launch.dryrun", "NamedSharding"): _NO_JAX + " (jax's sharding type)",
    ("launch.dryrun", "P"): _NO_JAX + " (jax's PartitionSpec)"}
MODULE_CASES = [(m, n) for m in MODULES
                for n in _public(importlib.import_module("repro." + m))]


def _port_module(mod):
    return importlib.import_module(
        "repro_torch." + PORT_MODULES.get(mod, mod))


@pytest.mark.parametrize("mod,name", MODULE_CASES,
                         ids=[f"{m}.{n}" for m, n in MODULE_CASES])
def test_reference_module_name_resolves_on_the_port(mod, name):
    port = _port_module(mod)
    if (mod, name) in DELIBERATE:
        assert not hasattr(port, name), DELIBERATE[(mod, name)]
        return
    name = RENAMES.get((mod, name), name)
    assert hasattr(port, name), f"{port.__name__}: {name!r} is missing"


@pytest.mark.parametrize("mod", [m for m in MODULES if hasattr(
    importlib.import_module("repro." + m), "__all__")])
def test_port_module_all_holds_the_reference_names(mod):
    ref = {RENAMES.get((mod, n), n)
           for n in importlib.import_module("repro." + mod).__all__
           if (mod, n) not in DELIBERATE}
    port = _port_module(mod)
    assert ref <= set(port.__all__)
    assert len(set(port.__all__)) == len(port.__all__)
    space = {}
    exec(f"from {port.__name__} import *", space)      # noqa: S102
    assert all(n in space for n in port.__all__)


# --------------------------------------------------------------------------- #
# class members                                                               #
# --------------------------------------------------------------------------- #
def _exported():
    """(reference module, name, object) of every case above, with the port
    module and name it resolves on."""
    for pkg, name in CASES:
        yield (getattr(_module("repro", pkg), name, None),
               "repro_torch" + ("." + pkg if pkg else ""), name)
    for sub, name in LAUNCH_CASES:
        ref = (DRYRUN[name] if sub == "dryrun" else getattr(
            importlib.import_module(f"repro.launch.{sub}"), name, None))
        yield ref, f"repro_torch.launch.{sub}", name
    for mod, name in MODULE_CASES:
        yield (getattr(importlib.import_module("repro." + mod), name),
               "repro_torch." + PORT_MODULES.get(mod, mod),
               RENAMES.get((mod, name), name))


def _class_cases():
    """One case per (class, public member), each class once, under the
    module that defines it; the port's class is found where the first
    name exporting it resolves."""
    cases, seen = [], set()
    for value, port_mod, port_name in _exported():
        if not (inspect.isclass(value)
                and value.__module__.startswith("repro.")
                and id(value) not in seen):
            continue
        seen.add(id(value))
        where = value.__module__[len("repro."):]
        cases += [(where, value.__qualname__, member, port_mod, port_name)
                  for member in dir(value) if not member.startswith("_")]
    return cases


CLASS_CASES = _class_cases()


@pytest.mark.parametrize("where,cls,member,port_mod,port_name", CLASS_CASES,
                         ids=[f"{w}.{c}.{m}" for w, c, m, _, _ in CLASS_CASES])
def test_reference_class_member_resolves_on_the_port(where, cls, member,
                                                     port_mod, port_name):
    port = getattr(importlib.import_module(port_mod), port_name)
    if (where, f"{cls}.{member}") in DELIBERATE:
        assert not hasattr(port, member), DELIBERATE[(where,
                                                      f"{cls}.{member}")]
        return
    assert hasattr(port, member), f"{port_mod}.{port_name}: {member!r}"


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


def test_collecting_the_surface_never_imports_the_reference_dry_run():
    """Building every case above leaves ``repro.launch.dryrun`` (and so its
    XLA_FLAGS) out of the process (a fresh one, so that no other test's
    import shows)."""
    import os
    import subprocess
    import sys

    probe = ("import os, sys; sys.path.insert(0, 'tests'); "
             "flags = os.environ.get('XLA_FLAGS', ''); "
             "import test_torch_facades as t; "
             "print(len(t.CLASS_CASES) > 0, "
             "'repro.launch.dryrun' in sys.modules, "
             "os.environ.get('XLA_FLAGS', '') == flags)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=300, check=True, cwd=root)
    assert out.stdout.split() == ["True", "False", "True"]
