"""MIMIC-CXR report section parsing (copy of radzero_tpu/preprocess/sections.py).

Clean-room rebuild of stage 1 of the reference's offline pipeline
(preprocess/mimic_cxr/create_section_files.py + section_parser.py,
themselves vendored from MIT-LCP/mimic-cxr): split a raw radiology
report into its titled sections so downstream stages can extract
FINDINGS / IMPRESSION text.

Approach: scan for UPPERCASE-ish section headers terminated by ':'
(the MIMIC convention), normalise known aliases, and return an ordered
{section: text} mapping plus the full cleaned report.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

# canonical names for the headers that matter downstream
SECTION_ALIASES = {
    "findings": "findings",
    "finding": "findings",
    "impression": "impression",
    "impressions": "impression",
    "conclusion": "impression",
    "conclusions": "impression",
    "indication": "indication",
    "history": "history",
    "clinical history": "history",
    "clinical indication": "indication",
    "comparison": "comparison",
    "comparisons": "comparison",
    "technique": "technique",
    "examination": "examination",
    "exam": "examination",
    "recommendation": "recommendation",
    "recommendations": "recommendation",
    "wet read": "wet_read",
    "final report": "report",
}

_HEADER_RE = re.compile(
    r"^\s*([A-Za-z][A-Za-z ]{1,40}?)\s*:", flags=re.MULTILINE
)


def normalize_section_name(name: str) -> str:
    key = name.strip().lower()
    return SECTION_ALIASES.get(key, key.replace(" ", "_"))


def section_text(report: str) -> Tuple[Dict[str, str], List[str]]:
    """-> ({section_name: text}, ordered section names).

    Headers are lines like 'FINDINGS:' / 'IMPRESSION:'; text before the
    first header lands in 'preamble'.
    """
    sections: Dict[str, str] = {}
    order: List[str] = []

    matches = []
    for m in _HEADER_RE.finditer(report):
        raw = m.group(1)
        # headers in MIMIC are (mostly) upper case; accept title case too,
        # reject obviously prose-like matches (e.g. times '10:30')
        if raw.strip() and (raw.isupper() or raw.strip().lower() in SECTION_ALIASES):
            matches.append((m.start(), m.end(), normalize_section_name(raw)))

    if not matches:
        return ({"full_report": report.strip()}, ["full_report"])

    if matches[0][0] > 0:
        pre = report[: matches[0][0]].strip()
        if pre:
            sections["preamble"] = pre
            order.append("preamble")

    for i, (start, end, name) in enumerate(matches):
        stop = matches[i + 1][0] if i + 1 < len(matches) else len(report)
        body = report[end:stop].strip()
        if name in sections:  # repeated header: concatenate
            sections[name] += "\n" + body
        else:
            sections[name] = body
            order.append(name)
    return sections, order


def full_report_sections(report: str) -> Dict[str, str]:
    """Convenience: just the dict."""
    return section_text(report)[0]
