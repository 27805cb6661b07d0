"""The port's layers point one way.

Every module of `boundless_tpu_torch/` is parsed with `ast`, and every
import of the package it makes, relative or absolute, at module level or
inside a function, is resolved to the module it names. A module may
import only from its own rank of `RANKS` or a lower one. The table
names every subpackage and top-level module, so that a new module has to
be given a rank; a package `__init__` without a rank of its own (the
package root, `utils/`) imports nothing of the package.
"""

import ast
import pathlib

import pytest

PKG = "boundless_tpu_torch"
ROOT = pathlib.Path(__file__).resolve().parents[1] / PKG

# rank -> the dotted names (relative to the package) of that rank; a
# module takes the rank of the longest name that is a prefix of it
LAYERS = {
    0: ("native", "utils.profiling", "utils.metrics", "utils.config",
        "utils.service_runner"),
    # one box: core dispatches to the kernels, and the kernels read the
    # field's constants
    1: ("core", "kernels"),
    2: ("air",),
    3: ("kernels.cons",),  # the constraint kernel generated from an AIR
    4: ("prover",),
    5: ("zkvm",),
    6: ("recursion",),
    7: ("utils.serde", "parallel"),  # the receipts' wire format; the mesh
    8: ("groth16",),
    9: ("cluster",),
    10: ("market",),
    11: ("convert", "cli"),
}
RANKS = {name: rank for rank, names in LAYERS.items() for name in names}
UNRANKED_PACKAGES = ("", "utils")


def rank_of(module: str):
    parts = module.split(".")
    for i in range(len(parts), 0, -1):
        rank = RANKS.get(".".join(parts[:i]))
        if rank is not None:
            return rank
    return None


def _module_name(path: pathlib.Path) -> str:
    parts = list(path.relative_to(ROOT).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


MODULES = {_module_name(p): p for p in sorted(ROOT.rglob("*.py"))}


def imports_of(module: str, source: str, is_package: bool):
    """[(line, imported module)] of every import of the package in
    `source`, the module `module` (a package's `__init__` if
    `is_package`), at any depth."""
    here = module.split(".") if module else []
    if not is_package:
        here = here[:-1]
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == PKG or alias.name.startswith(PKG + "."):
                    found.append((node.lineno, alias.name[len(PKG) + 1:]))
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = here[:len(here) - (node.level - 1)]
                target = ".".join(base + ([node.module] if node.module
                                          else []))
            elif node.module == PKG or (node.module or "").startswith(
                    PKG + "."):
                target = node.module[len(PKG) + 1:]
            else:
                continue
            for alias in node.names:
                sub = f"{target}.{alias.name}" if target else alias.name
                found.append((node.lineno,
                               sub if sub in MODULES else target))
    return found


def upward_imports(module: str, source: str, is_package: bool) -> list:
    """Each import of `module` into a higher rank, as a message naming the
    module, the line and the two ranks."""
    own = rank_of(module)
    return [f"{module}:{line} (rank {own}) imports {target} "
            f"(rank {rank_of(target)})"
            for line, target in imports_of(module, source, is_package)
            if rank_of(target) is None or rank_of(target) > own]


@pytest.mark.parametrize("rank", sorted(LAYERS))
def test_rank_imports_only_its_own_rank_or_lower(rank):
    mods = [m for m in MODULES if rank_of(m) == rank]
    assert mods, f"rank {rank} names no module"
    bad = [msg for m in mods
           for msg in upward_imports(m, MODULES[m].read_text(),
                                     MODULES[m].name == "__init__.py")]
    assert not bad, "\n".join(bad)


def test_every_module_has_a_rank():
    unranked = [m for m in MODULES
                if rank_of(m) is None and m not in UNRANKED_PACKAGES]
    assert not unranked, f"give these modules a rank: {unranked}"
    for pkg in UNRANKED_PACKAGES:
        init = MODULES[pkg]
        assert not imports_of(pkg, init.read_text(), True), init
    top = {p.name.removesuffix(".py") for p in ROOT.iterdir()
           if p.suffix == ".py" or (p / "__init__.py").exists()}
    top.discard("__init__")
    named = {name.split(".")[0] for name in RANKS}
    assert top <= named, f"not in the table: {sorted(top - named)}"


@pytest.mark.parametrize("module,source,upward", [
    ("air.dsl", "def f():\n    from ..prover.stark import ExtVal\n", 1),
    ("core.merkle", "from ..parallel import mesh\n", 1),
    ("utils.profiling",
     "import boundless_tpu_torch.cluster.metrics as M\n", 1),
    ("prover.stark", "from ..air import dsl\nfrom ..core import field\n",
     0),
])
def test_an_upward_import_is_caught(module, source, upward):
    assert len(upward_imports(module, source, False)) == upward
