"""
The port's public API against the JAX package's, module by module, on the
CPU: for every module of ``pisa_tpu`` (``pkgutil.walk_packages``), the
module of the same path in ``pisa_tpu_torch`` has each public name of the
JAX module, and each class there has every public attribute of the JAX
class's body (inherited ones count). The names checked are the JAX
module's ``__all__`` and every public name its own source defines at its
top level (functions, classes, assignments), so a constant or a helper
left out of ``__all__`` counts too.

What is not ported on purpose stands in :data:`NOT_PORTED`, each entry with
its reason, and the names the port gives under another name in
:data:`RENAMED`; nothing else may be missing. An entry fails the test when
the JAX package no longer has what it names, or when the port now has it,
so that neither list can go stale.

Every module of the port is also held to its rule of never importing JAX
or the JAX package: no import statement of its source names ``jax``,
``jaxlib`` or ``pisa_tpu``, and no global of the imported module is one of
their modules or objects.
"""

import ast
import importlib
import importlib.util
import inspect
import pkgutil

import pytest

import pisa_tpu
import pisa_tpu_torch

#: JAX module -> {name or "Class.attribute" (None: the whole module): why
#: the port leaves it out}
NOT_PORTED = {
    "pisa_tpu.ops.cplx": {
        None: "the split-complex TPU workaround; torch has complex dtypes",
    },
    "pisa_tpu.ops.osc.pallas_chain": {
        None: "the Pallas kernels, replaced by csrc/osc_chain.cu through"
              " ops/osc/chain.py",
    },
    "pisa_tpu.ops.osc.kernels": {
        **{name: "a 3x3 matrix helper over ops/cplx.py's split complex"
           for name in ("mat_of", "mat_to_C", "mat_to_numpy", "mat_mul",
                        "mat_conj_T", "mat_map", "mat_add", "smat_mul",
                        "smat_conj_T", "smat_view")},
        "PALLAS_JVP_AUTO": "the JAX switch between its Pallas jvp and XLA;"
                           " the port has one route for each prob3 option",
        "osc_grad_mode": "the JAX switch between its Pallas jvp and XLA; the"
                         " port has one route for each prob3 option",
    },
    "pisa_tpu.core.prior": {
        "Prior.llh_jax": "the JAX form of the prior's llh; the port has"
                         " Prior.llh_torch",
    },
    "pisa_tpu.core.translation": {
        "build_pull_transpose": "the dead pull-transpose branch"
                                " (ADVICE.md:3-4)",
        "gather_pull_transpose": "the dead pull-transpose branch"
                                 " (ADVICE.md:3-4)",
    },
}

#: JAX module -> {JAX name: the port's name for it}
RENAMED = {
    "pisa_tpu.ops.osc.nonstandard": {
        "std_nsi_eps_C": "std_nsi_eps",
        "vacuum_nsi_eps_C": "vacuum_nsi_eps",
        "decay_matrix_C": "decay_matrix",
    },
}

FORBIDDEN_ROOTS = ("jax", "jaxlib", "pisa_tpu")


def _modules(package):
    return [package.__name__] + sorted(
        m.name for m in pkgutil.walk_packages(package.__path__,
                                              package.__name__ + "."))


JAX_MODULES = _modules(pisa_tpu)
PORT_MODULES = _modules(pisa_tpu_torch)


def _port_name(name):
    return "pisa_tpu_torch" + name[len("pisa_tpu"):]


def _source_tree(module):
    with open(module.__file__, encoding="utf-8") as f:
        return ast.parse(f.read())


def _defined_names(module):
    """The names `module`'s own source binds at its top level."""
    names = set()
    for node in _source_tree(module).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            names.update(n.id for t in targets for n in ast.walk(t)
                         if isinstance(n, ast.Name))
    return names


def _public_names(module):
    names = set(getattr(module, "__all__", ())) | _defined_names(module)
    return sorted(n for n in names if not n.startswith("_"))


def _has(module, dotted):
    obj = module
    for part in dotted.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


def _missing(jax_module, port_module):
    """The JAX module's public names (and its classes' public attributes,
    as "Class.attribute") that the port's module lacks."""
    missing = []
    for name in _public_names(jax_module):
        if not hasattr(port_module, name):
            missing.append(name)
            continue
        value = getattr(jax_module, name)
        if inspect.isclass(value) and value.__module__ == jax_module.__name__:
            port_class = getattr(port_module, name)
            missing += [f"{name}.{attr}" for attr in vars(value)
                        if not attr.startswith("_")
                        and not hasattr(port_class, attr)]
    return missing


def test_allowlist_names_modules_of_the_jax_package():
    """Every module the two lists name is a module of the JAX package."""
    assert set(NOT_PORTED) | set(RENAMED) <= set(JAX_MODULES)


def test_jax_package_is_walked_whole():
    """The walk reaches the stage services and the subpackages, so a module
    cannot drop out of the comparison unseen."""
    assert "pisa_tpu.stages.flux.airs" in JAX_MODULES
    assert "pisa_tpu.stages.data.licloader_weighter" in JAX_MODULES
    assert "pisa_tpu.parallel.multihost" in JAX_MODULES
    assert len(JAX_MODULES) > 150


@pytest.mark.parametrize("name", JAX_MODULES)
def test_port_has_the_public_api_of(name):
    jax_module = importlib.import_module(name)
    omitted = NOT_PORTED.get(name, {})
    renamed = RENAMED.get(name, {})
    if None in omitted:
        assert set(omitted) == {None}
        assert importlib.util.find_spec(_port_name(name)) is None, (
            f"{_port_name(name)} exists now: take {name} out of NOT_PORTED")
        return
    port_module = importlib.import_module(_port_name(name))
    for entry in list(omitted) + list(renamed):
        assert _has(jax_module, entry), (
            f"{name} no longer has {entry}: take it out of the allowlist")
        assert not _has(port_module, entry), (
            f"{_port_name(name)} has {entry}: take it out of the allowlist")
    for target in renamed.values():
        assert _has(port_module, target), (
            f"{_port_name(name)} lacks {target}, the port's name for a JAX"
            " name")
    missing = [m for m in _missing(jax_module, port_module)
               if m not in omitted and m not in renamed]
    assert not missing, f"{_port_name(name)} lacks {missing}"


def _imported_roots(module):
    """The top-level packages every import statement of `module`'s source
    names, at any depth (imports inside functions too)."""
    roots = set()
    for node in ast.walk(_source_tree(module)):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def _origin_root(value):
    name = value.__name__ if inspect.ismodule(value) \
        else getattr(value, "__module__", None)
    return name.split(".")[0] if isinstance(name, str) else None


@pytest.mark.parametrize("name", PORT_MODULES)
def test_port_module_imports_no_jax(name):
    module = importlib.import_module(name)
    assert not _imported_roots(module) & set(FORBIDDEN_ROOTS)
    leaked = sorted(k for k, v in vars(module).items()
                    if _origin_root(v) in FORBIDDEN_ROOTS)
    assert not leaked, f"{name} holds {leaked} from JAX or the JAX package"
