"""mtlint configuration — the ``mtlint_torch.toml`` baseline.

The module must run on Python 3.10 (no stdlib ``tomllib``) and the
repo takes no new dependencies, so this module carries a parser for the
small TOML subset the baseline needs: ``[section]`` / ``[[array of
tables]]`` headers, string / int / float / bool scalars, and
single-line string arrays.  Anything fancier (multi-line strings,
inline tables, dotted keys) is rejected loudly rather than guessed at.

Baseline format::

    [[suppress]]
    rule = "MT-C202"            # required: exact rule id
    file = "mpit_tpu_torch/comm/native/build.py"   # required: path suffix
    content = "9f0b6a2c41de"    # preferred: content hash of the line
    line = 28                   # legacy alternative: exact line pin
    reason = "the lock exists precisely to serialize the build"

``reason`` is mandatory and must be non-empty — a baseline entry that
cannot say why it exists is a bug report, not a suppression.

``content`` is the line-move-tolerant key: the first 12 hex chars of
sha256 over the flagged line's stripped source text (printed by
``mtlint --suggest-baseline`` and carried in ``--json`` output).  It
survives unrelated edits above and below the site — the per-PR baseline
re-pin churn that ``line =`` pins forced is exactly what it replaces.
When both keys are present the content hash decides and the line is
commentary.
"""

from __future__ import annotations

import pathlib
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from mpit_tpu_torch.analysis.core import Finding

#: the port's own baseline: a scan of the port never discovers the JAX
#: package's ``mtlint.toml``, nor that package's scan this one.
CONFIG_NAME = "mtlint_torch.toml"


class ConfigError(ValueError):
    """Malformed baseline — always fatal, never a silent skip."""


def _strip_comment(line: str) -> str:
    out = []
    in_str = False
    for ch in line:
        if ch == '"':
            in_str = not in_str
        if ch == "#" and not in_str:
            break
        out.append(ch)
    return "".join(out).strip()


def _parse_value(raw: str, lineno: int):
    raw = raw.strip()
    if raw.startswith('"') and raw.endswith('"') and len(raw) >= 2:
        return raw[1:-1]
    if raw in ("true", "false"):
        return raw == "true"
    if raw.startswith("[") and raw.endswith("]"):
        inner = raw[1:-1].strip()
        if not inner:
            return []
        return [_parse_value(part, lineno)
                for part in re.split(r",(?=(?:[^\"]*\"[^\"]*\")*[^\"]*$)", inner)
                if part.strip()]
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        raise ConfigError(f"line {lineno}: cannot parse value {raw!r}")


def parse_toml_subset(text: str) -> Dict[str, object]:
    """Parse the TOML subset documented in the module docstring into
    nested dicts/lists (``[[name]]`` accumulates a list of dicts)."""
    data: Dict[str, object] = {}
    current: Dict[str, object] = data
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = _strip_comment(raw)
        if not line:
            continue
        if line.startswith("[[") and line.endswith("]]"):
            name = line[2:-2].strip()
            bucket = data.setdefault(name, [])
            if not isinstance(bucket, list):
                raise ConfigError(f"line {lineno}: {name!r} is not a table array")
            current = {}
            bucket.append(current)
        elif line.startswith("[") and line.endswith("]"):
            name = line[1:-1].strip()
            section = data.setdefault(name, {})
            if not isinstance(section, dict):
                raise ConfigError(f"line {lineno}: {name!r} is not a section")
            current = section
        elif "=" in line:
            key, _, value = line.partition("=")
            current[key.strip()] = _parse_value(value, lineno)
        else:
            raise ConfigError(f"line {lineno}: unparseable line {raw!r}")
    return data


@dataclass
class Suppression:
    rule: str
    file: str
    reason: str
    line: Optional[int] = None
    content: Optional[str] = None  # line-move-tolerant content hash
    hits: int = 0  # incremented as findings match (unused-entry report)

    def matches(self, finding: Finding) -> bool:
        if finding.rule != self.rule:
            return False
        if not finding.abspath.endswith(self.file):
            return False
        if self.content is not None:
            return finding.content == self.content
        if self.line is not None and finding.line != self.line:
            return False
        return True

    def render(self) -> str:
        pin = f"#{self.content}" if self.content is not None else (
            f":{self.line}" if self.line is not None else "")
        return f"{self.rule} @ {self.file}{pin} ({self.reason})"


@dataclass
class Config:
    suppressions: List[Suppression] = field(default_factory=list)
    source: Optional[pathlib.Path] = None


def load_config(path: pathlib.Path) -> Config:
    data = parse_toml_subset(path.read_text(encoding="utf-8"))
    sups = []
    for i, entry in enumerate(data.get("suppress", []) or []):
        if not isinstance(entry, dict):
            raise ConfigError(f"suppress entry {i} is not a table")
        missing = {"rule", "file", "reason"} - set(entry)
        if missing:
            raise ConfigError(
                f"suppress entry {i} missing {sorted(missing)} "
                "(every suppression must name its rule, file and reason)")
        if not str(entry["reason"]).strip():
            raise ConfigError(
                f"suppress entry {i} ({entry['rule']} @ {entry['file']}) "
                "has an empty reason — justify it or fix the finding")
        line = entry.get("line")
        content = entry.get("content")
        if content is not None and not re.fullmatch(
                r"[0-9a-f]{12}", str(content)):
            raise ConfigError(
                f"suppress entry {i} ({entry['rule']} @ {entry['file']}) "
                f"has a malformed content key {content!r} — expected 12 "
                "hex chars (see `mtlint --suggest-baseline`)")
        sups.append(Suppression(
            rule=str(entry["rule"]), file=str(entry["file"]),
            reason=str(entry["reason"]),
            line=int(line) if line is not None else None,
            content=str(content) if content is not None else None))
    return Config(suppressions=sups, source=path)


def discover_config(start: pathlib.Path) -> Optional[Config]:
    """Find ``CONFIG_NAME`` in ``start`` (a file's directory or the scan
    root) or the nearest ancestor — the usual repo-root discovery."""
    node = start.resolve()
    if node.is_file():
        node = node.parent
    for candidate in [node, *node.parents]:
        cfg = candidate / CONFIG_NAME
        if cfg.is_file():
            return load_config(cfg)
    return None
