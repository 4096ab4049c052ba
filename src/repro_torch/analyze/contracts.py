"""Contract-registry checker (checker 1 of ``repro_torch.analyze``).

Counterpart of ``repro/analyze/contracts.py``.  Each kernel family
directory under ``src/repro_torch/kernels/`` may declare a
machine-readable ``CONTRACT`` in its ``ops.py``: the family's identity
class (``integer`` kernels give the same integers on every backend;
``f32-bit-exact`` kernels promise the same f32 operation ORDER, so FMA
contraction and approximate division are forbidden -- see
``kernel_check``), the ops the family exports, their output dtypes and
shapes, and the positional signature of each backend of the numpy /
plain / CUDA triple annotated with semantic ROLES.  The port's triple is
``numpy`` (the host mirror in ``ops.py``), ``ref`` (the plain PyTorch
version in ``ref.py``) and ``cuda`` (the wrapper in ``kernel.py``, which
also names the ``csrc/`` source it launches), where the reference's is
numpy / ref / pallas.

The checker is AST-level on purpose: ``CONTRACT`` must be a pure literal
(``ast.literal_eval``-able), so contracts are verifiable without importing
the family -- and therefore without torch -- and fixture trees in tests
are plain files.  What it verifies:

* every required family declares a literal ``CONTRACT``;
* identity class is valid, and an ``integer`` family declares no float
  outputs;
* every op declares all three backends, each naming a function that exists
  in the declared module (``ops`` / ``ref`` / ``kernel``) whose positional
  parameter names match the contract EXACTLY and in order -- the signature
  drift detector: renaming or reordering a parameter without updating the
  contract fails the gate;
* a ``cuda`` backend names a ``csrc/<name>.cu`` source that exists;
* the role multiset of every backend resolves to the op's declared role
  set, where ``staging=a+b`` params (one argument carrying several roles)
  expand to their carried roles and ``gather`` / ``config`` params (row
  and block indices the arena-resident backends gather through, tile
  counts) are backend-local and excluded.
"""

from __future__ import annotations

import ast
import pathlib
import re

from .discovery import SRC_ROOT
from .report import Finding

REQUIRED_FAMILIES = ("bm25_score", "blockmax_pivot", "vbyte_decode", "ef_search")
IDENTITY_CLASSES = ("integer", "f32-bit-exact")
BACKENDS = ("numpy", "ref", "cuda")
LOCAL_ROLES = ("gather", "config")  # backend-local, excluded from agreement
_MODULE_FILES = {"ops": "ops.py", "ref": "ref.py", "kernel": "kernel.py"}
_OUT_RE = re.compile(r"^\w+:([a-z]+\d*)\[[\w,]*\]$")
_SOURCE_RE = re.compile(r"^csrc/\w+\.cu$")
_FLOAT_DTYPES = ("float16", "bfloat16", "float32", "float64")


def load_contract(ops_path: pathlib.Path):
    """(contract dict | None, error string | None) from one ops.py."""
    tree = ast.parse(ops_path.read_text(), filename=str(ops_path))
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            if isinstance(target, ast.Name) and target.id == "CONTRACT":
                try:
                    return ast.literal_eval(node.value), None
                except ValueError:
                    return None, "CONTRACT is not a pure literal"
    return None, None


def _function_defs(path: pathlib.Path) -> dict[str, ast.FunctionDef]:
    tree = ast.parse(path.read_text(), filename=str(path))
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def _positional_params(fn: ast.FunctionDef) -> list[str]:
    args = fn.args
    return [a.arg for a in args.posonlyargs] + [a.arg for a in args.args]


def _split_param(param: str) -> tuple[str, str]:
    name, _, role = param.partition(":")
    return name, role


def _effective_roles(params: list[str]) -> set[str]:
    roles: set[str] = set()
    for _, role in map(_split_param, params):
        if role.startswith("staging="):
            roles.update(role[len("staging=") :].split("+"))
        elif role not in LOCAL_ROLES:
            roles.add(role)
    return roles


def _check_source(pkg_root, bwhere, spec, findings) -> None:
    """A ``cuda`` backend must name the CUDA source its wrapper launches."""
    source = spec.get("source", "")
    if not _SOURCE_RE.match(source):
        findings.append(
            Finding(
                "contracts",
                "missing-source",
                bwhere,
                f"cuda backend names no 'csrc/<name>.cu' source (got {source!r})",
            )
        )
    elif not (pkg_root / source).exists():
        findings.append(
            Finding("contracts", "missing-source", bwhere, f"{source} does not exist")
        )


def _check_op(family_dir, family, op_name, op, identity, findings) -> None:
    where = f"{family}/{op_name}"
    declared_roles = set(op.get("roles", ()))
    for out in op.get("out", ()):
        m = _OUT_RE.match(out)
        if not m:
            findings.append(
                Finding(
                    "contracts",
                    "out-format",
                    where,
                    f"output {out!r} is not 'name:dtype[dims]'",
                )
            )
        elif identity == "integer" and m.group(1) in _FLOAT_DTYPES:
            findings.append(
                Finding(
                    "contracts",
                    "integer-float-out",
                    where,
                    f"integer-class family declares float output {out!r}",
                )
            )
    backends = op.get("backends", {})
    for backend in BACKENDS:
        if backend not in backends:
            findings.append(
                Finding(
                    "contracts",
                    "missing-backend",
                    where,
                    f"triple is incomplete: no {backend!r} backend declared",
                )
            )
    for backend, spec in backends.items():
        bwhere = f"{where}[{backend}]"
        if backend == "cuda":
            _check_source(family_dir.parent.parent, bwhere, spec, findings)
        mod_file = _MODULE_FILES.get(spec.get("module"))
        if mod_file is None:
            findings.append(
                Finding(
                    "contracts",
                    "unknown-module",
                    bwhere,
                    f"module {spec.get('module')!r} not in {sorted(_MODULE_FILES)}",
                )
            )
            continue
        mod_path = family_dir / mod_file
        if not mod_path.exists():
            findings.append(
                Finding(
                    "contracts", "missing-module", bwhere, f"{mod_file} does not exist"
                )
            )
            continue
        fn = _function_defs(mod_path).get(spec.get("fn", ""))
        if fn is None:
            findings.append(
                Finding(
                    "contracts",
                    "missing-fn",
                    bwhere,
                    f"{mod_file} defines no function {spec.get('fn')!r}",
                )
            )
            continue
        declared = [_split_param(p)[0] for p in spec.get("params", ())]
        actual = _positional_params(fn)
        if declared != actual:
            findings.append(
                Finding(
                    "contracts",
                    "signature-mismatch",
                    bwhere,
                    f"{spec['fn']}() takes {actual}, contract declares {declared}",
                )
            )
            continue
        roles = _effective_roles(list(spec.get("params", ())))
        if roles != declared_roles:
            findings.append(
                Finding(
                    "contracts",
                    "role-mismatch",
                    bwhere,
                    f"params resolve roles {sorted(roles)}, "
                    f"op declares {sorted(declared_roles)}",
                )
            )


def check_family(family_dir: pathlib.Path, findings: list[Finding]) -> bool:
    """Check one family directory; True iff it declares a CONTRACT."""
    family = family_dir.name
    contract, err = load_contract(family_dir / "ops.py")
    if err is not None:
        findings.append(Finding("contracts", "contract-not-literal", family, err))
        return True
    if contract is None:
        return False
    if contract.get("family") != family:
        findings.append(
            Finding(
                "contracts",
                "family-name",
                family,
                f"CONTRACT names family {contract.get('family')!r}",
            )
        )
    identity = contract.get("identity")
    if identity not in IDENTITY_CLASSES:
        findings.append(
            Finding(
                "contracts",
                "identity-class",
                family,
                f"identity {identity!r} not in {IDENTITY_CLASSES}",
            )
        )
    for op_name, op in contract.get("ops", {}).items():
        _check_op(family_dir, family, op_name, op, identity, findings)
    return True


def check_contracts(kernels_root=None, required=None) -> list[Finding]:
    """Findings over every contract-declaring family under ``kernels_root``.

    ``required`` families (default: the reference's four when checking the
    real tree) must declare a CONTRACT; other families are checked iff
    they declare one.  A ``cuda`` source resolves against the parent of
    ``kernels_root`` (the package root, which holds ``csrc/``).
    """
    if kernels_root is None:
        kernels_root = SRC_ROOT / "kernels"
        if required is None:
            required = REQUIRED_FAMILIES
    required = tuple(required or ())
    findings: list[Finding] = []
    declared: set[str] = set()
    for family_dir in sorted(pathlib.Path(kernels_root).iterdir()):
        if not (family_dir / "ops.py").exists():
            continue
        if check_family(family_dir, findings):
            declared.add(family_dir.name)
    for family in required:
        if family not in declared:
            findings.append(
                Finding(
                    "contracts",
                    "missing-contract",
                    family,
                    "required kernel family declares no CONTRACT in ops.py",
                )
            )
    return findings
