"""Public-API parity: every public name of every ``repro.*`` module exists
in its ``repro_torch.*`` counterpart, with the same kind (module, class,
callable or constant), and every flag of a reference launcher's command
line is a flag of the port's, but for the exceptions listed below.

A public name is one without a leading underscore that the module
defines or re-exports from the package: a class or callable whose
``__module__`` starts with ``repro``, a submodule of a package, or an
upper-case constant. A submodule of the same name does not stand in for
a function (``kernels.paged_gather`` is the op, as in the reference).

``repro.launch.dryrun`` is read from its source, never imported: at
import it rewrites ``XLA_FLAGS`` to 512 host devices.
"""
import ast
import importlib
import inspect
import pkgutil
import types
import warnings
from pathlib import Path

import pytest
import torch

import repro
import repro_torch

# one intra-op thread: the suite's pytest-xdist workers share the
# cores, and oversubscribed OpenMP pools spin against each other
torch.set_num_threads(1)

# reference module -> port module, where the port renames it:
# hlo_analysis walks XLA's HLO text; the port counts an eager call
MODULES = {"repro.launch.hlo_analysis": "repro_torch.launch.cost_analysis"}

# (reference module, name): why the port has no such name
EXCEPTIONS = {
    # the port has no HLO: parsing it and its instruction records are
    # XLA-only
    ("repro.launch.hlo_analysis", "parse_hlo"): "HLO-only",
    ("repro.launch.hlo_analysis", "Instr"): "HLO-only",
    ("repro.launch.hlo_analysis", "Computation"): "HLO-only",
    # the reference's perf-regression gate over the JAX payloads waits
    # for the port's own benchmark
    ("repro.launch.dryrun", "check_bench"): "no port benchmark yet",
}
# names the port gives another name: reference -> port
RENAMED = {
    ("repro.launch", "hlo_analysis"): "cost_analysis",
    # the spinner kernel's kinds (the Pallas kernel's in the reference)
    ("repro.kernels.spinner", "PALLAS_KINDS"): "KERNEL_KINDS",
    # the interconnect: TPU ICI in the reference, NVLink on the card
    ("repro.launch.hlo_analysis", "ICI_BW"): "LINK_BW",
}
# HBM_PER_CHIP (repro.launch.dryrun) keeps its name and means the card's
# memory in the port; the *_pallas entry points are TPU-only (the port's
# CUDA wrappers are the kernels' *_cuda functions)
TPU_ONLY_SUFFIX = "_pallas"
# launcher flags with no port counterpart
FLAG_EXCEPTIONS = {
    ("repro.launch.dryrun", "--check-bench"): "no port benchmark yet",
    ("repro.launch.dryrun", "--bench-dir"): "--check-bench's directory",
    ("repro.launch.dryrun", "--hlo-dir"): "the port has no HLO to dump",
}
NOT_IMPORTED = {"repro.launch.dryrun"}


def _module_names(pkg):
    return [pkg.__name__] + [m.name for m in pkgutil.walk_packages(
        pkg.__path__, pkg.__name__ + ".")]


def _import(name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return importlib.import_module(name)


REF_MODULES = [n for n in _module_names(repro) if n not in NOT_IMPORTED]
for _n in REF_MODULES + _module_names(repro_torch):
    _import(_n)


def _port_name(name):
    return MODULES.get(name, "repro_torch" + name[len("repro"):])


def _kind(obj):
    if isinstance(obj, types.ModuleType):
        return "module"
    if inspect.isclass(obj):
        return "class"
    if callable(obj):
        return "callable"
    return "value"


def _public(mod):
    """{name: kind} of a module's public names (the module docstring)."""
    out = {}
    for name, obj in vars(mod).items():
        if name.startswith("_"):
            continue
        kind = _kind(obj)
        if kind == "module":
            if obj.__name__ != f"{mod.__name__}.{name}":
                continue
        elif kind == "value":
            if not name.isupper():
                continue
        elif not str(getattr(obj, "__module__", "")).startswith("repro"):
            continue
        out[name] = kind
    return out


def _source(name):
    return Path(importlib.util.find_spec(name).origin).read_text()


def _public_from_source(name):
    """{name: kind} of a module's top-level defs, classes and upper-case
    constants, from its source."""
    out = {}
    for node in ast.parse(_source(name)).body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = "callable"
        elif isinstance(node, ast.ClassDef):
            out[node.name] = "class"
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id.isupper():
                    out[t.id] = "value"
    return {k: v for k, v in out.items() if not k.startswith("_")}


def _flags(name):
    """The ``--flags`` a module's ``add_argument`` calls declare."""
    out = set()
    for node in ast.walk(ast.parse(_source(name))):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "add_argument":
            out.update(a.value for a in node.args
                       if isinstance(a, ast.Constant)
                       and str(a.value).startswith("--"))
    return out


@pytest.mark.parametrize("name", REF_MODULES + sorted(NOT_IMPORTED))
def test_every_public_name_has_a_port_counterpart(name):
    want = _public_from_source(name) if name in NOT_IMPORTED \
        else _public(importlib.import_module(name))
    port = importlib.import_module(_port_name(name))
    missing, wrong = [], []
    for attr, kind in sorted(want.items()):
        if attr.endswith(TPU_ONLY_SUFFIX) or (name, attr) in EXCEPTIONS:
            continue
        got = RENAMED.get((name, attr), attr)
        if not hasattr(port, got):
            missing.append(attr)
        elif _kind(getattr(port, got)) != kind:
            wrong.append((attr, kind, _kind(getattr(port, got))))
    assert not missing, f"{port.__name__} lacks {missing}"
    assert not wrong, f"{port.__name__}: (name, reference kind, port kind) " \
                      f"{wrong}"


LAUNCHERS = [n for n in REF_MODULES + sorted(NOT_IMPORTED)
             if n.startswith("repro.launch.") and _flags(n)]


@pytest.mark.parametrize("name", LAUNCHERS)
def test_every_launcher_flag_has_a_port_counterpart(name):
    missing = {f for f in _flags(name) - _flags(_port_name(name))
               if (name, f) not in FLAG_EXCEPTIONS}
    assert not missing, f"{_port_name(name)} lacks {sorted(missing)}"


def test_exceptions_name_what_the_reference_has():
    """Every exception and rename is a real reference name, and every
    rename's target exists in the port."""
    for (mod, attr) in list(EXCEPTIONS) + list(RENAMED):
        want = _public_from_source(mod) if mod in NOT_IMPORTED \
            else _public(importlib.import_module(mod))
        assert attr in want, (mod, attr)
    for (mod, attr), new in RENAMED.items():
        assert hasattr(importlib.import_module(_port_name(mod)), new)
    for (mod, flag) in FLAG_EXCEPTIONS:
        assert flag in _flags(mod), (mod, flag)


def test_new_modules_import_and_the_ops_shadow_their_modules():
    for name in ("repro_torch.configs.shapes", "repro_torch.launch.dryrun",
                 "repro_torch.launch.cost_analysis"):
        importlib.import_module(name)
    from repro_torch import kernels
    from repro_torch.kernels import ops
    for op in ("fwht", "paged_gather", "srf_decode", "spinner_project",
               "spinner_plan", "circulant_project"):
        assert getattr(kernels, op) is getattr(ops, op)
    assert importlib.import_module(
        "repro_torch.kernels.paged_gather").paged_gather_cuda


def test_spinner_plan_mirrors_the_cuda_launch_plan():
    """``ops.spinner_plan`` reports ``csrc/spinner.cu``'s ``pick_mt``:
    (BM, BN) = (128, 128) where G * ceil(m / 128) * ceil(B / 128) blocks
    still give every SM two, else (32, 128); the VMEM ``budget``, dtype
    and kind do not change it."""
    from repro_torch.kernels import ops
    assert ops.spinner_plan("circulant", 128, 256, G=8, B=32,
                            sm_count=132) == (32, 128)
    assert ops.spinner_plan("circulant", 1024, 4096, B=8192,
                            sm_count=132) == (128, 128)
    assert ops.spinner_plan("toeplitz", 1024, 4096, B=8192, sm_count=132,
                            budget=1, dtype=torch.bfloat16,
                            seeded=True) == (128, 128)
    # 2 * 132 = 264 blocks: 33 column tiles x 8 row tiles is the edge
    assert ops.spinner_plan("circulant", 128, 33 * 128, B=1024,
                            sm_count=132) == (128, 128)
    assert ops.spinner_plan("circulant", 128, 32 * 128, B=1024,
                            sm_count=132) == (32, 128)
    assert ops.spinner_plan("circulant", 128, 256) == (32, 128)
