"""1D sample-set JSON persistence (ref: sampler/sampler_json.go).

The port's own copy of dieselfluid_tpu/io/sampler_json.py (plain Python
and numpy). The reference's schema is SamplerJSON {samplerMeta{name,
samplerID}, samples_1D{domain, values, count}}; its shipped data files
(ref: data/CIEX.json etc.) are not valid JSON (no colon after
"samplerMeta", arrays wrapped in braces). This module writes valid JSON
and reads the reference's dialect through a lenient repair pass.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import List


@dataclasses.dataclass
class SamplerJSON:
    name: str = ""
    sampler_id: int = 0
    domain: List[float] = dataclasses.field(default_factory=list)
    values: List[float] = dataclasses.field(default_factory=list)

    def export_json(self, path: str):
        """Write valid JSON in the reference's schema. ref: ExportJSON:27-34."""
        doc = {
            "samplerMeta": {"name": self.name, "samplerID": self.sampler_id},
            "samples_1D": {
                "domain": list(map(float, self.domain)),
                "values": list(map(float, self.values)),
                "count": len(self.values),
            },
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)

    @staticmethod
    def import_json(path: str) -> "SamplerJSON":
        """Read the schema — valid JSON or the reference's malformed dialect."""
        with open(path) as f:
            text = f.read()
        try:
            doc = json.loads(text)
        except json.JSONDecodeError:
            doc = json.loads(_repair_reference_dialect(text))
        meta = doc.get("samplerMeta", {})
        s1d = doc.get("samples_1D", {})
        return SamplerJSON(
            name=meta.get("name", ""),
            sampler_id=int(meta.get("samplerID", 0)),
            domain=list(s1d.get("domain", [])),
            values=list(s1d.get("values", [])),
        )


def _repair_reference_dialect(text: str) -> str:
    """Fix the reference data files' syntax: insert missing colons after
    string keys followed by '{', and convert numeric-list braces to brackets."""
    # "key"{  ->  "key": {
    text = re.sub(r'("\w+")\s*\{', r"\1: {", text)
    # Brace-wrapped numeric lists -> brackets: find '{' whose body has no ':'
    out = []
    i = 0
    while i < len(text):
        c = text[i]
        if c == "{":
            j = _match_brace(text, i)
            body = text[i + 1:j]
            if ":" not in body and re.search(r"[\d.eE+-]", body):
                out.append("[" + body + "]")
                i = j + 1
                continue
        out.append(c)
        i += 1
    return "".join(out)


def _match_brace(text: str, start: int) -> int:
    depth = 0
    for i in range(start, len(text)):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                return i
    return len(text) - 1


def lerp(c, v0, v1):
    """ref: sampler_utilities.go Lerp:15-21 (out-of-range c clamps to v0)."""
    if c < 0.0 or c > 1.0:
        c = 0.0
    return v0 + (v1 - v0) * c


def sample_average_1d(domain, values, start_domain: float, end_domain: float) -> float:
    """Windowed average of samples whose domain lies in [start, end].

    ref: sampler_utilities.go SampleAverage1D:53-102 (used by the spectrum
    resampler to bin CIE tables).
    """
    import numpy as np

    domain = np.asarray(domain)
    values = np.asarray(values)
    sel = (domain >= start_domain) & (domain <= end_domain)
    if not sel.any():
        return 0.0
    return float(values[sel].mean())
