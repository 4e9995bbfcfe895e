"""Counter-name parsing shared by the SLO engine.

Only ``shed_reason_from_counter`` lives here so far; the exporters
(JSONL, Prometheus, Chrome trace) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["shed_reason_from_counter"]


def shed_reason_from_counter(name: str) -> Optional[str]:
    """The shed reason of a rendered ``serve.shed{reason=...}`` counter
    name (None when ``name`` is not a shed counter; ``(unlabelled)``
    for a bare ``serve.shed``)."""
    if name == "serve.shed":
        return "(unlabelled)"
    if name.startswith("serve.shed{"):
        return name[len("serve.shed{"):-1].split("=", 1)[-1]
    return None
