"""
SARIF 2.1.0 subset emitter for graftlint findings.

CI code-scanning surfaces (and most editors) ingest SARIF natively; this
module maps the graftlint finding model onto the minimal valid subset:
one run, one driver, one rule descriptor per GL code, one result per
finding with a physical location and the fix-it as the result message's
second paragraph.  Pure stdlib, no third-party SARIF packages — the
schema subset is small enough that hand-rolling it is less surface than
a dependency (and the container image bakes in nothing SARIF-aware).

Stability contract: the output is deterministic for a given finding list
(rules sorted by code, results in engine order, no timestamps), so the
artifact diffs cleanly between CI runs.
"""
from __future__ import annotations

import json

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)


def _rule_descriptor(code: str, name: str, desc: str) -> dict:
    return {
        "id": code,
        "name": name,
        "shortDescription": {"text": name},
        "fullDescription": {"text": desc},
        "defaultConfiguration": {"level": "error"},
    }


def _result(finding) -> dict:
    return {
        "ruleId": finding.rule,
        "level": "error",
        "message": {"text": f"{finding.message}\n\nfix-it: {finding.fixit}"},
        "locations": [
            {
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": finding.path,
                        "uriBaseId": "SRCROOT",
                    },
                    "region": {
                        "startLine": finding.line,
                        "startColumn": max(1, finding.col),
                    },
                }
            }
        ],
    }


def to_sarif(findings, rule_info: dict) -> dict:
    """Build the SARIF log dict for `findings`.

    `rule_info` is the graftlint RULE_INFO map (code -> (name, desc));
    every known rule is listed in the driver even when it produced no
    results — code-scanning UIs use the rule table to render "passing"
    checks, not just failures.
    """
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "graftlint",
                        "informationUri": (
                            "https://github.com/mRcSchwering/magic-soup"
                        ),
                        "rules": [
                            _rule_descriptor(code, name, desc)
                            for code, (name, desc) in sorted(rule_info.items())
                        ],
                    }
                },
                "columnKind": "utf16CodeUnits",
                "results": [_result(f) for f in findings],
            }
        ],
    }


def write_sarif(path, findings, rule_info: dict) -> None:
    """Serialize `findings` as a SARIF 2.1.0 log at `path`."""
    log = to_sarif(findings, rule_info)
    with open(path, "w") as fh:
        json.dump(log, fh, indent=2, sort_keys=False)
        fh.write("\n")
