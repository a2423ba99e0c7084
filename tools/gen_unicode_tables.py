#!/usr/bin/env python
"""Generate ssi_jax/native/src/unicode_tables.h from Python's unicodedata.

The native BPE scanner (bpe.cc) needs three character classes from the cl100k
split regex: \\p{L} (letters), \\p{N} (numbers) and \\s (Unicode White_Space).
\\p{Co} (private use) is three fixed ranges and is hardcoded in C++.

Tables are emitted as sorted [lo, hi] codepoint ranges binary-searched at
runtime. Python 3.12's unicodedata implements Unicode 15.0 — the same major
version tiktoken's regex crates target — and the differential fuzz tests in
tests/test_native_bpe.py guard the equivalence on the ranges real text uses.

Run: python tools/gen_unicode_tables.py  (rewrites the header in place)
"""

import sys
import unicodedata
from pathlib import Path

# Unicode White_Space property (PropList.txt) — stable for decades.
WHITESPACE_RANGES = [
    (0x0009, 0x000D), (0x0020, 0x0020), (0x0085, 0x0085), (0x00A0, 0x00A0),
    (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029), (0x202F, 0x202F),
    (0x205F, 0x205F), (0x3000, 0x3000),
]


def ranges_for(categories: set[str]) -> list[tuple[int, int]]:
    ranges: list[tuple[int, int]] = []
    start = None
    for cp in range(0x110000):
        in_class = unicodedata.category(chr(cp)) in categories
        if in_class and start is None:
            start = cp
        elif not in_class and start is not None:
            ranges.append((start, cp - 1))
            start = None
    if start is not None:
        ranges.append((start, 0x10FFFF))
    return ranges


def emit(name: str, ranges: list[tuple[int, int]]) -> str:
    rows = ",\n".join(
        "    " + ", ".join(f"{{0x{lo:X}, 0x{hi:X}}}" for lo, hi in ranges[i : i + 4])
        for i in range(0, len(ranges), 4)
    )
    return (
        f"inline constexpr CpRange {name}[] = {{\n{rows}\n}};\n"
        f"inline constexpr size_t {name}_len = {len(ranges)};\n\n"
    )


def main() -> None:
    letters = ranges_for({"Lu", "Ll", "Lt", "Lm", "Lo"})
    numbers = ranges_for({"Nd", "Nl", "No"})
    out = (
        "// GENERATED by tools/gen_unicode_tables.py — do not edit by hand.\n"
        f"// Source: Python {sys.version.split()[0]} unicodedata "
        f"(Unicode {unicodedata.unidata_version}).\n"
        "#pragma once\n\n"
        "#include <cstddef>\n"
        "#include <cstdint>\n\n"
        "namespace uni {\n\n"
        "struct CpRange { uint32_t lo, hi; };\n\n"
        + emit("kLetter", letters)
        + emit("kNumber", numbers)
        + emit("kWhitespace", WHITESPACE_RANGES)
        + "}  // namespace uni\n"
    )
    path = Path(__file__).parent.parent / "ssi_jax" / "native" / "src" / "unicode_tables.h"
    path.write_text(out)
    print(f"wrote {path}: {len(letters)} letter ranges, {len(numbers)} number ranges")


if __name__ == "__main__":
    main()
