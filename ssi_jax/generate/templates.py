"""Prompt-template rendering for standalone sample-wise generation.

The reference ships seven ad-hoc Jinja templates consumed by its planned
standalone-generation feature (ref: ssi/templates/*.jinja;
plans/Feature - Standalone Sample-Wise Generation.md:30-41). This module provides
the renderer that feature specifies: project variables ``MODALITY_TOKEN_SPEECH`` /
``MODALITY_TOKEN_TEXT`` are injected automatically; ``speech_tokens`` is a
PUA-encoded DSU string built from raw token IDs.
"""

from __future__ import annotations

from itertools import groupby
from pathlib import Path
from typing import Any

from ssi_jax.speech import MODALITY_TOKEN_SPEECH, MODALITY_TOKEN_TEXT, dsu2pua

TEMPLATES_DIR = Path(__file__).resolve().parent.parent / "templates"


def list_templates() -> list[str]:
    return sorted(p.stem for p in TEMPLATES_DIR.glob("*.jinja"))


def render_template(
    template: str | Path,
    speech_tokens: list[int] | None = None,
    deduplicate: bool = False,
    **variables: Any,
) -> str:
    """Render a prompt template by name (from ssi_jax/templates) or path.

    Args:
        template: template stem (e.g. ``"basic"``) or a path to a ``.jinja`` file.
        speech_tokens: raw DSU ids; rendered as a PUA character span.
        deduplicate: drop consecutive duplicate speech tokens before encoding.
        **variables: additional template variables.
    """
    import jinja2

    path = Path(template)
    if not path.suffix:
        path = TEMPLATES_DIR / f"{template}.jinja"
    if not path.exists():
        raise FileNotFoundError(f"Template not found: {path} (available: {list_templates()})")

    env_vars: dict[str, Any] = {
        "MODALITY_TOKEN_SPEECH": MODALITY_TOKEN_SPEECH,
        "MODALITY_TOKEN_TEXT": MODALITY_TOKEN_TEXT,
        **variables,
    }
    if speech_tokens is not None:
        toks = [k for k, _ in groupby(speech_tokens)] if deduplicate else list(speech_tokens)
        env_vars["speech_tokens"] = "".join(dsu2pua(t) for t in toks)

    tmpl = jinja2.Environment(undefined=jinja2.StrictUndefined, keep_trailing_newline=True).from_string(
        path.read_text()
    )
    return tmpl.render(**env_vars)
