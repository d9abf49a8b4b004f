"""Prompt grammar "text:weight" — ``parse_prompt`` copied from
``cgd_tpu/guidance/prompts.py`` (pure Python), pinned to the original by
tests/test_torch_port_api.py."""

from __future__ import annotations

from typing import Tuple


def parse_prompt(prompt: str) -> Tuple[str, float]:
    """Split ``"text:weight"`` into (text, weight); weight defaults to 1.

    An http(s) prompt keeps the colon after its scheme: the scheme is peeled
    off first, so only a colon in the *remainder* separates a weight (e.g.
    ``"http://x/a.png:0.5"`` -> ("http://x/a.png", 0.5) but a bare URL stays
    whole). A non-numeric weight raises ValueError, as in the reference.
    """
    if prompt.startswith(("http://", "https://")):
        scheme, rest = prompt.split(":", 1)
        body, sep, tail = rest.rpartition(":")
        return (f"{scheme}:{body}", float(tail)) if sep else (prompt, 1.0)
    body, sep, tail = prompt.rpartition(":")
    return (body, float(tail)) if sep else (prompt, 1.0)
