"""graftlint engine: module model, suppressions, CLI
(`factorvae_tpu/analysis/engine.py`, the rules that are not about JAX).

The unit of analysis is one module. For each file the engine builds a
`ModuleModel`: the parsed AST, the import-alias table (`np` -> `numpy`,
...), every function (nested defs and lambdas included) and the parent
map the rules walk. The rules in rules.py consume that model and emit
`Finding`s; the engine then applies the suppression comments and decides
the exit code.

Name resolution is deliberately module-local and name-based: a call to
`chunk_scores(...)` links to ANY local `def chunk_scores` — including a
closure returned by a factory. The over-approximation this buys
(same-named unrelated functions link too) is the standard lint
trade-off; suppressions carry the rare false positive.

The JAX package's trace reachability, jit-wrapper tables and hot-path
prefixes serve only its JAX rules (JGL001-005) and are not here.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import io
import json
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

_SUPPRESS_RE = re.compile(
    r"graftlint:\s*disable=([A-Za-z0-9_,]+)[ \t]*(.*)$"
)
@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str
    suppressed: bool = False
    justification: str = ""
    # Whole-program fields: set by the concurrency rules in
    # --project mode. `thread_reachable` marks a finding whose flagged
    # scope runs off the main thread (thread target, executor submit,
    # HTTP handler, signal handler); `entry_point` names the entry the
    # reachability walk reached it through. Module-local findings keep
    # the defaults, so the JSON schema is additive, never breaking.
    thread_reachable: bool = False
    entry_point: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Suppression:
    line: int          # code line the suppression applies to
    rules: Set[str]
    justification: str
    comment_line: int  # where the comment physically lives


@dataclasses.dataclass
class FuncInfo:
    node: ast.AST                      # FunctionDef | AsyncFunctionDef | Lambda
    name: str                          # "<lambda>" for lambdas
    qualname: str
    parent: Optional["FuncInfo"]

    def decorator_list(self) -> list:
        return getattr(self.node, "decorator_list", [])


class ModuleModel:
    """Everything the rules need to know about one parsed module."""

    def __init__(self, path: str, src: str, tree: ast.Module):
        self.path = path
        self.src = src
        self.tree = tree
        self.aliases = _collect_aliases(tree)
        self.functions: List[FuncInfo] = []
        self._func_by_node: Dict[ast.AST, FuncInfo] = {}
        self._funcs_by_name: Dict[str, List[FuncInfo]] = {}
        self._parents: Dict[ast.AST, ast.AST] = {}
        self._collect_functions()

    # -- structure ---------------------------------------------------------

    def resolve(self, expr: ast.AST) -> Optional[str]:
        """Dotted name of an expression through the import-alias table
        (`np.zeros` -> "numpy.zeros"), or None for non-name exprs."""
        parts = []
        while isinstance(expr, ast.Attribute):
            parts.append(expr.attr)
            expr = expr.value
        if not isinstance(expr, ast.Name):
            return None
        parts.append(expr.id)
        parts.reverse()
        head = self.aliases.get(parts[0], parts[0])
        return ".".join([head] + parts[1:])

    def funcs_named(self, name: str) -> List[FuncInfo]:
        return self._funcs_by_name.get(name, [])

    def enclosing_function(self, node: ast.AST) -> Optional[FuncInfo]:
        cur = self._parents.get(node)
        while cur is not None:
            info = self._func_by_node.get(cur)
            if info is not None:
                return info
            cur = self._parents.get(cur)
        return None

    def func_of(self, node: ast.AST) -> Optional[FuncInfo]:
        return self._func_by_node.get(node)

    def _collect_functions(self) -> None:
        def visit(node, parent_info, prefix):
            for child in ast.iter_child_nodes(node):
                self._parents[child] = node
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qn = f"{prefix}{child.name}"
                    info = FuncInfo(child, child.name, qn, parent_info)
                    self._register(info)
                    visit(child, info, qn + ".")
                elif isinstance(child, ast.Lambda):
                    qn = f"{prefix}<lambda@{child.lineno}>"
                    info = FuncInfo(child, "<lambda>", qn, parent_info)
                    self._register(info)
                    visit(child, info, qn + ".")
                elif isinstance(child, ast.ClassDef):
                    visit(child, parent_info, f"{prefix}{child.name}.")
                else:
                    visit(child, parent_info, prefix)

        visit(self.tree, None, "")

    def _register(self, info: FuncInfo) -> None:
        self.functions.append(info)
        self._func_by_node[info.node] = info
        self._funcs_by_name.setdefault(info.name, []).append(info)


# ---------------------------------------------------------------------------
# small AST helpers shared with rules.py


def _collect_aliases(tree: ast.Module) -> Dict[str, str]:
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _terminal_name(expr: ast.AST) -> Optional[str]:
    """`foo` -> "foo"; `self.fns.foo` -> "foo" (the name-match key)."""
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


def _local_nodes(fn_node: ast.AST, *types) -> Iterable[ast.AST]:
    """Walk a function body WITHOUT descending into nested def/lambda
    (those are separate FuncInfos and get their own pass)."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if not types or isinstance(node, tuple(types)):
            yield node
        stack.extend(ast.iter_child_nodes(node))


# ---------------------------------------------------------------------------
# suppressions


def _parse_suppressions(src: str) -> List[Suppression]:
    """All `# graftlint: disable=...` comments. A comment on a code line
    applies to that line; a standalone comment line applies to the next
    line that carries code. The caller turns empty justifications into
    JGL000 findings."""
    lines = src.splitlines()
    sups: List[Suppression] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(src).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return sups
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        lineno = tok.start[0]
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        justification = m.group(2).strip().lstrip("-— ").strip()
        standalone = lines[lineno - 1][: tok.start[1]].strip() == ""
        target = lineno
        if standalone:
            for nxt in range(lineno, len(lines)):
                stripped = lines[nxt].strip()
                if stripped and not stripped.startswith("#"):
                    target = nxt + 1
                    break
        sups.append(Suppression(target, rules, justification, lineno))
    return sups


# ---------------------------------------------------------------------------
# the passes


def _innermost_stmt_starts(tree: ast.Module) -> Dict[int, int]:
    """line -> first line of the INNERMOST statement spanning it (so a
    suppression on any physical line of a wrapped statement matches
    findings anchored to any other line of the same statement, without
    letting a big compound statement — a whole function body — swallow
    suppressions meant for one inner statement)."""
    best: Dict[int, Tuple[int, int]] = {}  # line -> (span_len, start)
    for node in ast.walk(tree):
        if not isinstance(node, ast.stmt):
            continue
        # decorator lines belong to the decorated statement: findings on
        # a decorated def anchor at the `def` line, but the natural
        # suppression placement is on the decorator
        first = node.lineno
        for dec in getattr(node, "decorator_list", []):
            first = min(first, dec.lineno)
        end = getattr(node, "end_lineno", None) or node.lineno
        span = (end - first, node.lineno)
        for ln in range(first, end + 1):
            if ln not in best or span < best[ln]:
                best[ln] = span
    return {ln: start for ln, (_, start) in best.items()}


def apply_suppressions(src: str, tree: ast.Module, path: str,
                       findings: List[Finding]) -> List[Finding]:
    """Apply the file's `graftlint: disable` comments to `findings`
    (marking covered ones suppressed) and append the JGL000 meta
    findings for unjustified suppressions. Shared by the module-local
    pass (analyze_source) and the whole-program pass (analyze_project),
    so suppression semantics are identical in both modes."""
    sups = _parse_suppressions(src)
    meta: List[Finding] = []
    for s in sups:
        if not s.justification:
            meta.append(Finding(
                "JGL000", path, s.comment_line,
                "graftlint suppression without a justification — say WHY "
                "the rule does not apply here",
            ))

    # A suppression covers a finding on the same physical line OR on the
    # same (innermost) multi-line statement: with wrapped calls the
    # finding anchors at the statement's first line while the trailing
    # comment physically sits on the last — both must match.
    stmt_of = _innermost_stmt_starts(tree)

    def covers(s: Suppression, f: Finding) -> bool:
        if not s.justification or not (f.rule in s.rules or "all" in s.rules):
            return False
        if s.line == f.line:
            return True
        s_stmt = stmt_of.get(s.line)
        return s_stmt is not None and s_stmt == stmt_of.get(f.line)

    out: List[Finding] = []
    for f in findings:
        sup = next((s for s in sups if covers(s, f)), None)
        if sup is not None:
            out.append(dataclasses.replace(
                f, suppressed=True, justification=sup.justification))
        else:
            out.append(f)
    out.extend(meta)
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


def run_module_rules(model: ModuleModel) -> List[Finding]:
    """Every module-local rule over one built model (no suppression
    application — the caller owns that so project mode can merge
    module-local and whole-program findings first)."""
    from factorvae_tpu_torch.analysis import rules as _rules

    findings: List[Finding] = []
    for rule_fn in _rules.ALL_RULES:
        findings.extend(rule_fn(model))
    return findings


def analyze_source(src: str, path: str = "<string>") -> List[Finding]:
    """Run every rule over one module's source. Findings covered by a
    justified suppression come back with suppressed=True; an unjustified
    suppression is itself a JGL000 finding."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding("JGL000", path, e.lineno or 1,
                        f"unparseable file: {e.msg}")]
    model = ModuleModel(path, src, tree)
    return apply_suppressions(src, tree, path, run_module_rules(model))


def _walk_py_files(root_dir: str) -> Iterable[str]:
    for root, dirs, files in os.walk(root_dir):
        dirs[:] = sorted(
            d for d in dirs
            if d != "__pycache__" and not d.startswith(".")
        )
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(root, name)


def collect_sources(paths: Sequence[str]
                    ) -> Tuple[List[Tuple[str, Optional[str], str]],
                               List[Finding]]:
    """Resolve CLI paths into [(file_path, package_root_or_None, src)]
    plus the JGL000 findings for anything missing/unreadable — a typo'd
    path must fail the gate loudly, never turn it into a green no-op.
    `package_root` is the directory argument a file was found under
    (the whole-program index derives dotted module names from it);
    files passed directly carry None and index as standalone modules."""
    out: List[Tuple[str, Optional[str], str]] = []
    findings: List[Finding] = []
    for p in paths:
        if os.path.isfile(p):
            if not p.endswith(".py"):
                findings.append(Finding(
                    "JGL000", p, 1, "not a Python file — nothing analyzed"))
                continue
            files = [(p, None)]
        elif os.path.isdir(p):
            files = [(f, p) for f in _walk_py_files(p)]
            if not files:
                findings.append(Finding(
                    "JGL000", p, 1,
                    "no Python files under this path — the gate would "
                    "check nothing here"))
                continue
        else:
            findings.append(Finding(
                "JGL000", p, 1,
                "path does not exist — a typo here would silently turn "
                "the lint gate into a no-op"))
            continue
        for fp, root in files:
            try:
                with open(fp, "r", encoding="utf-8") as fh:
                    src = fh.read()
            except (OSError, UnicodeDecodeError) as e:
                findings.append(Finding(
                    "JGL000", fp, 1, f"unreadable file: {e}"))
                continue
            out.append((fp, root, src))
    return out, findings


def analyze_paths(paths: Sequence[str]) -> List[Finding]:
    """Analyze every .py file under `paths` with the module-local
    rules (per-path mode: each file stands alone, reachability stops at
    its module boundary — see analyze_project for whole-program mode)."""
    sources, findings = collect_sources(paths)
    for fp, _, src in sources:
        findings.extend(analyze_source(src, fp))
    return findings


def analyze_project(paths: Sequence[str]) -> List[Finding]:
    """Whole-program mode: build one cross-module project index over
    every file, run the module-local rules, then the project-level
    concurrency rules (JGL009-011) on top. Suppression semantics are identical to per-path mode."""
    from factorvae_tpu_torch.analysis import concurrency
    from factorvae_tpu_torch.analysis.project import ProjectIndex

    sources, findings = collect_sources(paths)
    # One file reachable through two CLI paths (passed directly AND
    # under a directory argument) must index — and report — once.
    seen_paths: set = set()
    deduped = []
    for fp, root, src in sources:
        ap = os.path.abspath(fp)
        if ap in seen_paths:
            continue
        seen_paths.add(ap)
        deduped.append((fp, root, src))
    index = ProjectIndex(deduped)
    findings.extend(index.errors)          # unparseable files -> JGL000
    per_file: Dict[str, List[Finding]] = {}
    for rec in index.records():
        per_file.setdefault(rec.path, []).extend(
            run_module_rules(rec.model))
    for rule_fn in concurrency.PROJECT_RULES:
        for f in rule_fn(index):
            per_file.setdefault(f.path, []).append(f)
    for rec in index.records():
        findings.extend(apply_suppressions(
            rec.src, rec.tree, rec.path, per_file.get(rec.path, [])))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def default_project_paths() -> List[str]:
    """`--project` with no paths: the port's package plus the repo's
    `scripts/torch_*.py` next to it — the same surface the tier-1
    per-path gate lints."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = [pkg]
    scripts = os.path.join(os.path.dirname(pkg), "scripts")
    if os.path.isdir(scripts):
        out.extend(os.path.join(scripts, name)
                   for name in sorted(os.listdir(scripts))
                   if name.startswith("torch_") and name.endswith(".py"))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m factorvae_tpu_torch.analysis",
        description="graftlint: static analysis of the port (prints, "
                    "swallowed errors, clocks, timeouts, spans, and with "
                    "--project lock discipline)",
    )
    parser.add_argument("paths", nargs="*",
                        help="files or directories to analyze (required "
                             "unless --project, which defaults to the "
                             "installed package + scripts/torch_*.py)")
    parser.add_argument("--project", action="store_true",
                        help="whole-program mode: one cross-module index "
                             "(import-resolved call graph, thread-entry "
                             "reachability) over every path, enabling the "
                             "concurrency rules JGL009-011")
    parser.add_argument("--format", choices=("human", "json"),
                        default="human")
    parser.add_argument("--show-suppressed", action="store_true",
                        help="also list findings silenced by justified "
                             "suppressions")
    args = parser.parse_args(argv)

    paths = list(args.paths)
    if not paths:
        if not args.project:
            parser.error("paths are required without --project")
        paths = default_project_paths()
    findings = (analyze_project(paths) if args.project
                else analyze_paths(paths))
    active = [f for f in findings if not f.suppressed]
    suppressed = [f for f in findings if f.suppressed]

    if args.format == "json":
        print(json.dumps({
            "findings": [f.to_dict() for f in active],
            "suppressed": [f.to_dict() for f in suppressed],
            "counts": {"active": len(active), "suppressed": len(suppressed)},
        }, indent=2))
    else:
        for f in active:
            print(f"{f.path}:{f.line}: {f.rule} {f.message}")
        if args.show_suppressed:
            for f in suppressed:
                print(f"{f.path}:{f.line}: {f.rule} [suppressed: "
                      f"{f.justification}] {f.message}")
        print(f"{len(active)} finding(s), {len(suppressed)} suppressed")
    return 1 if active else 0
