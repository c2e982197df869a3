"""mtlint engine — run every rule family over a tree, apply the baseline."""

from __future__ import annotations

import pathlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from mpit_tpu_torch.analysis import (callgraph, concurrency, disciplines,
                                     obsrules, ownership, protocol, schema,
                                     torchrules)
from mpit_tpu_torch.analysis.config import Config, Suppression
from mpit_tpu_torch.analysis.core import Finding, collect


@dataclass
class Report:
    findings: List[Finding] = field(default_factory=list)  # unsuppressed
    suppressed: List[Tuple[Finding, Suppression]] = field(default_factory=list)
    unused_suppressions: List[Suppression] = field(default_factory=list)

    @property
    def exit_code(self) -> int:
        return 1 if self.findings else 0

    def merge(self, other: "Report") -> None:
        self.findings.extend(other.findings)
        self.suppressed.extend(other.suppressed)
        self.unused_suppressions.extend(other.unused_suppressions)


def run(target, config: Optional[Config] = None) -> Report:
    """Lint one file or directory tree.  ``config`` carries the baseline;
    suppression accounting (``unused_suppressions``) is per-run."""
    files, findings = collect(pathlib.Path(target))
    # ONE interprocedural summary pass (and one parsed AST, held by the
    # SourceFile) shared by every family that looks through calls.
    graph = callgraph.build_graph(files)
    findings = list(findings)
    findings += protocol.check(files, graph)
    findings += concurrency.check(files, graph)
    findings += torchrules.check(files, graph)
    findings += obsrules.check(files)
    findings += schema.check(files)
    findings += disciplines.check(files, graph)
    findings += ownership.check(files, graph)
    findings.sort(key=Finding.sort_key)

    report = Report()
    sups = list(config.suppressions) if config else []
    used = set()
    for f in findings:
        matched = next((s for s in sups if s.matches(f)), None)
        if matched is not None:
            matched.hits += 1
            used.add(id(matched))
            report.suppressed.append((f, matched))
        else:
            report.findings.append(f)
    report.unused_suppressions = [s for s in sups if id(s) not in used]
    return report
