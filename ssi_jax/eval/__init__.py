"""Evaluation subsystem: WER + text normalization.

The reference computes WER with HF ``evaluate`` (jiwer) after Whisper English text
normalization (ref: scripts/wer.py:59-73). Neither jiwer nor the standalone
``whisper_normalizer`` package is a dependency here:

- :func:`word_error_rate` is a first-party corpus-level WER (total edit distance /
  total reference words) — the same definition jiwer/evaluate implement.
- :func:`english_normalizer` returns transformers' vendored Whisper
  ``EnglishTextNormalizer`` with the vendored British->American spelling mapping
  (``english_spelling.json``, a first-party reconstruction of Whisper's
  ``english.json`` — see :func:`load_spelling_mapping` for scope and caveats).
"""

from ssi_jax.eval.wer import english_normalizer, load_spelling_mapping, word_error_rate  # noqa: F401
