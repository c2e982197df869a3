"""mtlint core — finding model, rule registry, source loading.

The analyzer is deliberately stdlib-only (ast + pathlib): it reads
source and needs no device, so it runs on any host without importing
torch or building the native transport.  Nothing in
mpit_tpu_torch.analysis imports the code under analysis — modules are
*parsed*, never executed (the one exception is the spec-drift check,
which executes the stdlib-only binding generator; see
mpit_tpu_torch.analysis.protocol).
"""

from __future__ import annotations

import ast
import hashlib
import pathlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

ERROR = "error"
WARN = "warn"
INFO = "info"

#: rule id -> (default severity, one-line description).  The id is the
#: stable contract: baselines, tests and docs key on it.  Each rule
#: family registers its own entries (``register_rules`` at module
#: import) so the catalog lives next to the checker that owns it; the
#: engine imports every family before any finding is created.
RULES: Dict[str, Tuple[str, str]] = {
    # -- engine ------------------------------------------------------------
    "MT-X001": (ERROR, "file does not parse"),
}


def register_rules(rules: Dict[str, Tuple[str, str]]) -> None:
    """Add one family's rules to the shared catalog (idempotent; a
    conflicting re-registration is a programming error, caught loudly)."""
    for rid, spec in rules.items():
        if rid in RULES and RULES[rid] != spec:
            raise ValueError(f"rule {rid} registered twice with different "
                             f"specs: {RULES[rid]} vs {spec}")
        RULES[rid] = spec


def content_key(srcline: str) -> str:
    """The line-move-tolerant baseline key for a finding's source line:
    the first 12 hex chars of sha256 over the whitespace-stripped line.
    Stable across unrelated edits above/below the suppressed site —
    re-pinning a baseline because server.py grew a function is exactly
    the churn this replaces."""
    return hashlib.sha256(srcline.strip().encode("utf-8")).hexdigest()[:12]


@dataclass
class Finding:
    rule: str
    path: str  # posix path relative to the scan root (display form)
    line: int
    message: str
    severity: str = ""
    abspath: str = ""  # posix absolute path (baseline matching form)
    srcline: str = ""  # stripped source text of the flagged line

    def __post_init__(self) -> None:
        if not self.severity:
            self.severity = RULES.get(self.rule, (WARN, ""))[0]

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}"

    @property
    def content(self) -> str:
        """The content-hash suppression key (empty when the source line
        is unknown — synthetic findings suppress by line instead)."""
        return content_key(self.srcline) if self.srcline else ""

    def render(self) -> str:
        return f"{self.location}: {self.rule} [{self.severity}] {self.message}"

    def sort_key(self):
        return (self.path, self.line, self.rule, self.message)


@dataclass
class SourceFile:
    path: pathlib.Path  # absolute
    rel: str  # posix, relative to scan root
    text: str
    tree: ast.Module

    def line_text(self, line: int) -> str:
        lines = self.text.splitlines()
        return lines[line - 1].strip() if 0 < line <= len(lines) else ""

    def finding(self, rule: str, node_or_line, message: str) -> Finding:
        line = getattr(node_or_line, "lineno", node_or_line)
        return Finding(rule, self.rel, int(line), message,
                       abspath=self.path.as_posix(),
                       srcline=self.line_text(int(line)))


_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules", "build", "dist"}


def collect(root: pathlib.Path) -> Tuple[List[SourceFile], List[Finding]]:
    """Parse every .py file under ``root`` (or ``root`` itself when it is
    a file).  Unparseable files become MT-X001 findings, not crashes."""
    root = pathlib.Path(root).resolve()
    if root.is_file():
        paths = [root]
        base = root.parent
    else:
        paths = sorted(
            p for p in root.rglob("*.py")
            if not any(part in _SKIP_DIRS or part.startswith(".")
                       for part in p.relative_to(root).parts)
        )
        base = root
    files: List[SourceFile] = []
    findings: List[Finding] = []
    for p in paths:
        rel = p.relative_to(base).as_posix()
        try:
            text = p.read_text(encoding="utf-8")
            tree = ast.parse(text, filename=str(p))
        except (SyntaxError, UnicodeDecodeError) as exc:
            findings.append(Finding(
                "MT-X001", rel, getattr(exc, "lineno", 1) or 1,
                f"parse failure: {exc.__class__.__name__}: {exc}",
                abspath=p.as_posix()))
            continue
        files.append(SourceFile(path=p, rel=rel, text=text, tree=tree))
    return files, findings


def callee_name(call: ast.Call) -> Optional[str]:
    """Terminal name of the called object: f(...) -> 'f', a.b.c(...) -> 'c'."""
    func = call.func
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def root_name(node: ast.AST) -> Optional[str]:
    """Leftmost name of an attribute chain: a.b.c -> 'a'; plain Name -> id."""
    while isinstance(node, ast.Attribute):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def iter_functions(tree: ast.Module):
    """Yield (qualname, FunctionDef) for every def at any nesting level."""

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                yield qual, child
                yield from walk(child, qual + ".")
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.")
            else:
                yield from walk(child, prefix)

    yield from walk(tree, "")
