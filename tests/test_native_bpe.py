"""Differential tests: first-party C++ BPE core vs tiktoken (the contract).

The DSU pipeline depends on bit-identical token streams (ref:
ssi/tokenizer/monkeypatch.py:7 — the PUA regex exists precisely so DSU
characters tokenize 1:1). The native core must therefore match tiktoken
token-for-token on every input, including the regex edge cases: contractions
under case folding (incl. U+017F long s), PUA planes 0/15/16, digit
chunking, whitespace lookahead, and CR/LF glue.
"""

import base64
import random

import pytest

from ssi_jax.native import bpe as native_bpe
from ssi_jax.tokenizer import CL100K_PATTERN_PUA

pytestmark = pytest.mark.skipif(not native_bpe.available(), reason="no C++ toolchain")


def _train_ranks(n_merges: int = 400) -> dict[bytes, int]:
    """Tiny greedy BPE training over a mixed corpus — produces realistic
    multi-level merge chains (merges of merges) for the differential tests."""
    corpus = (
        b"the quick brown fox jumps over the lazy dog " * 40
        + "ことばのテスト、多言語テキストです。".encode() * 15
        + b"print('hello world') # 1234 567 " * 25
        + "éèüöß café naïve ".encode() * 20
    )
    ranks = {bytes([i]): i for i in range(256)}
    seq = [bytes([b]) for b in corpus]
    for r in range(256, 256 + n_merges):
        counts: dict[tuple[bytes, bytes], int] = {}
        for a, b in zip(seq, seq[1:]):
            counts[(a, b)] = counts.get((a, b), 0) + 1
        if not counts:
            break
        (a, b), cnt = max(counts.items(), key=lambda kv: (kv[1], kv[0]))
        if cnt < 2:
            break
        ranks[a + b] = r
        merged, i = [], 0
        while i < len(seq):
            if i + 1 < len(seq) and seq[i] == a and seq[i + 1] == b:
                merged.append(a + b)
                i += 2
            else:
                merged.append(seq[i])
                i += 1
        seq = merged
    return ranks


@pytest.fixture(scope="module")
def encoders(tmp_path_factory):
    import tiktoken

    ranks = _train_ranks()
    path = tmp_path_factory.mktemp("bpe") / "tokenizer.model"
    with open(path, "w") as f:
        for tok, r in sorted(ranks.items(), key=lambda kv: kv[1]):
            f.write(base64.b64encode(tok).decode() + f" {r}\n")
    specials = {"<|begin_of_text|>": len(ranks), "<|end_of_text|>": len(ranks) + 1}
    tt = tiktoken.Encoding(
        name="t", pat_str=CL100K_PATTERN_PUA, mergeable_ranks=ranks, special_tokens=specials
    )
    nat = native_bpe.NativeEncoding(str(path), specials)
    return tt, nat, path


EDGE_CASES = [
    "",
    "hello world",
    "   leading",
    "trailing   ",
    "a\n\nb",
    "  \n  \n",
    "\r\n\r\n",
    "'s 'T 're 'VE 'll 'd",
    "'ſ ſ'ſ a'ſand",  # long s folds to 's' inside (?i:'s)
    "don't CAN'T won'T o'clock",
    "123456789",
    "a1b2c3",
    "...!!!???",
    " !",
    "word  word",
    "  x",
    " 1",
    "  　",  # exotic whitespace: NBSP, LS, ideographic space
    "",  # BMP private use
    "\U000f0000\U0010fffd",  # planes 15/16 private use
    "" * 8 + "text" + "",
    "日本語テキスト中文混在",
    "emoji 😀👍 done",
]


def test_edge_cases_bit_identical(encoders):
    tt, nat, _ = encoders
    for s in EDGE_CASES:
        assert nat.encode(s) == tt.encode(s, allowed_special=set(), disallowed_special=()), repr(s)


def test_fuzz_bit_identical(encoders):
    tt, nat, _ = encoders
    alphabet = list(
        "abcdefghij THEQUICKtheol 'ſS'sſ éß日本語中文 0123456789.,!?;:()[]#@-_\n\r\t   　"
    ) + ["", "", "", "\U000f0000", "\U00100000", "😀", "'"]
    rng = random.Random(1)
    for _ in range(1500):
        s = "".join(rng.choice(alphabet) for _ in range(rng.randint(1, 80)))
        assert nat.encode(s) == tt.encode(s, allowed_special=set(), disallowed_special=()), repr(s)


def test_decode_round_trip_with_specials(encoders):
    tt, nat, _ = encoders
    text = "hello 'ſ world  中文"
    ids = tt.encode(text, allowed_special=set(), disallowed_special=())
    ids = [nat.special_tokens["<|begin_of_text|>"]] + ids + [nat.special_tokens["<|end_of_text|>"]]
    assert nat.decode(ids) == tt.decode(ids)
    assert nat.n_vocab == tt.n_vocab


def test_out_of_range_decode_raises(encoders):
    _, nat, _ = encoders
    with pytest.raises(KeyError):
        nat.decode([10**6])


def test_malformed_merges_file_rejected(tmp_path):
    bad = tmp_path / "bad.model"
    bad.write_text("notbase64!!! 0\n")
    with pytest.raises(OSError):
        native_bpe.NativeEncoding(str(bad))
    empty = tmp_path / "empty.model"
    empty.write_text("")
    with pytest.raises(OSError):
        native_bpe.NativeEncoding(str(empty))


def _byte_alphabet_lines() -> list[str]:
    return [base64.b64encode(bytes([b])).decode() + f" {b}" for b in range(256)]


def test_structurally_invalid_vocabs_rejected(tmp_path):
    """Load-time strictness: a rank gap, a duplicate token, or a missing byte
    would otherwise surface later as silent id -1 from encode or "" from decode
    (advisor finding, native/src/bpe.cc)."""
    # rank gap: 0..255 bytes then rank 257 (256 missing)
    gap = tmp_path / "gap.model"
    gap.write_text("\n".join(_byte_alphabet_lines() + [base64.b64encode(b"ab").decode() + " 257"]) + "\n")
    with pytest.raises(OSError, match="[Nn]on-contiguous"):
        native_bpe.NativeEncoding(str(gap))

    # duplicate token string
    dup = tmp_path / "dup.model"
    dup.write_text("\n".join(_byte_alphabet_lines() + [base64.b64encode(bytes([65])).decode() + " 256"]) + "\n")
    with pytest.raises(OSError, match="duplicate token"):
        native_bpe.NativeEncoding(str(dup))

    # incomplete byte alphabet: contiguous ranks but byte 255 replaced by "ab"
    inc = tmp_path / "inc.model"
    lines = _byte_alphabet_lines()[:-1] + [base64.b64encode(b"ab").decode() + " 255"]
    inc.write_text("\n".join(lines) + "\n")
    with pytest.raises(OSError, match="incomplete byte alphabet"):
        native_bpe.NativeEncoding(str(inc))

    # the minimal valid vocab (exactly the byte alphabet) still loads
    ok = tmp_path / "ok.model"
    ok.write_text("\n".join(_byte_alphabet_lines()) + "\n")
    enc = native_bpe.NativeEncoding(str(ok))
    assert enc.n_vocab == 256
    assert enc.decode(enc.encode("hi")) == "hi"


def test_tokenizer_auto_backend_matches_tiktoken(tmp_path, monkeypatch):
    """Llama3Tokenizer(auto) and Llama3Tokenizer(tiktoken) agree end-to-end."""
    import sys

    sys.path.insert(0, "tests")
    import helpers

    from ssi_jax.tokenizer import setup_llama3_tokenizer

    path = helpers.write_tiny_tokenizer(tmp_path / "tokenizer.model")
    tok_auto, _ = setup_llama3_tokenizer(path, verbose=False)
    assert tok_auto._native is not None  # toolchain present -> native core active
    monkeypatch.setenv("SSI_JAX_NATIVE_BPE", "0")
    tok_tt, _ = setup_llama3_tokenizer(path, verbose=False)
    assert tok_tt._native is None
    for s in ["hello world", "  mixed 123 ", "a'ſb"]:
        assert tok_auto.encode(s) == tok_tt.encode(s)
        assert tok_auto.decode(tok_auto.encode(s)) == tok_tt.decode(tok_tt.encode(s))
