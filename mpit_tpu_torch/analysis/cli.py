"""mtlint CLI — ``python tools/torch_mtlint.py [paths...]`` / the
``mtlint-torch`` console entry.

Exit status: 0 when every finding is covered by a justified baseline
entry (or there are none), 1 when unsuppressed findings remain, 2 on
bad configuration.  Unused baseline entries are reported as warnings
but do not fail the run — they fail the *next* baseline review.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import List, Optional

from mpit_tpu_torch.analysis.config import (
    Config,
    ConfigError,
    discover_config,
    load_config,
)
from mpit_tpu_torch.analysis.engine import Report, run


def _parse_args(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="mtlint-torch",
        description="framework-aware static analysis for mpit_tpu_torch: "
        "PS protocol conformance, lock discipline, torch hot-path hygiene "
        "(reads source; needs no device).",
    )
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories to lint (default: mpit_tpu_torch/)")
    ap.add_argument("--config", type=pathlib.Path, default=None,
                    help="explicit baseline (default: the nearest "
                    "mtlint_torch.toml above the first path)")
    ap.add_argument("--no-config", action="store_true",
                    help="ignore any baseline")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--suggest-baseline", action="store_true",
                    help="print ready-to-paste baseline entries (with "
                    "line-move-tolerant content keys) for every "
                    "unsuppressed finding")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="findings only, no summary")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = _parse_args(argv)
    paths = [pathlib.Path(p) for p in (args.paths or ["mpit_tpu_torch"])]
    for p in paths:
        if not p.exists():
            print(f"mtlint: no such path: {p}", file=sys.stderr)
            return 2

    config: Optional[Config] = None
    if not args.no_config:
        try:
            if args.config is not None:
                config = load_config(args.config)
            else:
                config = discover_config(paths[0])
        except (ConfigError, OSError) as exc:
            print(f"mtlint: bad config: {exc}", file=sys.stderr)
            return 2

    report = Report()
    for p in paths:
        report.merge(run(p, config))
    if config and len(paths) > 1:
        # Per-run accounting over-reports across paths: an entry is
        # unused only when no path's findings matched it.
        used = {id(s) for _, s in report.suppressed}
        report.unused_suppressions = [
            s for s in config.suppressions if id(s) not in used]

    if args.as_json:
        def as_dict(f):
            d = dict(vars(f))
            d["content"] = f.content
            return d

        print(json.dumps({
            "findings": [as_dict(f) for f in report.findings],
            "suppressed": [
                {"finding": as_dict(f), "reason": s.reason}
                for f, s in report.suppressed
            ],
            "unused_suppressions": [s.render() for s in
                                    report.unused_suppressions],
        }, indent=2))
        return report.exit_code

    if args.suggest_baseline:
        # A suggested content key that equals an EXISTING entry's hash
        # (same stripped line text flagged elsewhere, or a 48-bit
        # collision) must not be emitted as another content entry: the
        # loader would treat the two as one, and whichever matched
        # first would silently swallow the other's findings.  Pin those
        # by line instead, loudly.
        existing = {}
        for s in (config.suppressions if config else []):
            if s.content:
                existing.setdefault(s.content, s)
        for f in report.findings:
            clash = existing.get(f.content) if f.content else None
            print("[[suppress]]")
            print(f'rule = "{f.rule}"')
            print(f'file = "{f.path}"')
            if f.content and clash is None:
                print(f'content = "{f.content}"  # {f.location}')
            elif clash is not None:
                print(f"# content key {f.content} already claimed by the "
                      f"{clash.rule} entry for {clash.file} — a second "
                      "content entry would silently merge with it; "
                      "pinned by line instead")
                print(f"line = {f.line}  # {f.location}")
            else:
                print(f"line = {f.line}")
            print('reason = "FIXME: justify or fix '
                  f'({f.message[:60]}...)"')
            print()
        return report.exit_code

    for f in report.findings:
        print(f.render())
    if not args.quiet:
        for s in report.unused_suppressions:
            print(f"mtlint: warning: unused baseline entry: {s.render()}",
                  file=sys.stderr)
        n, m = len(report.findings), len(report.suppressed)
        src = f" (baseline: {config.source})" if config and config.source else ""
        print(f"mtlint: {n} finding(s), {m} suppressed{src}")
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
