"""Tokenizer + extension contract tests.

Mirrors the vocab-arithmetic and bit-identity checks of the reference
(ref: scripts/extend_llama3_2.py:132-138; ssi/tokenizer/monkeypatch.py:7;
ssi/tokenizer/__init__.py:14-31).
"""

import pytest

from ssi_jax.extend import extend_tiktoken
from ssi_jax.speech import MODALITY_TOKEN_SPEECH, MODALITY_TOKEN_TEXT, dsu2pua, pua2dsu
from ssi_jax.tokenizer import LLAMA3_SPECIAL_TOKENS, setup_llama3_tokenizer
from ssi_jax.tokenizer.messages import Message, validate_messages
from tests.helpers import write_tiny_tokenizer


def test_256_special_tokens():
    assert len(LLAMA3_SPECIAL_TOKENS) == 256
    assert LLAMA3_SPECIAL_TOKENS["<|begin_of_text|>"] == 128_000
    assert LLAMA3_SPECIAL_TOKENS["<|end_of_text|>"] == 128_001
    assert LLAMA3_SPECIAL_TOKENS["<|finetune_right_pad_id|>"] == 128_004
    assert LLAMA3_SPECIAL_TOKENS["<|eot_id|>"] == 128_009


def test_dynamic_special_token_assignment(tiny_tokenizer_path):
    tokenizer, specials = setup_llama3_tokenizer(tiny_tokenizer_path, verbose=False)
    # specials float above the (unextended) base vocab
    assert tokenizer.base_vocab_size == 256
    assert specials["<|begin_of_text|>"] == 256
    assert specials["<|end_of_text|>"] == 257
    assert tokenizer.vocab_size == 512
    assert tokenizer.bos_id == 256 and tokenizer.eos_id == 257


def test_extension_shifts_specials(tiny_extended_tokenizer_path):
    """After extension specials move to [base + n_dsus + 2, ...) — the reference's
    [133002, 133258) shift at full scale (ref: SURVEY.md §3.2)."""
    tokenizer, specials = setup_llama3_tokenizer(tiny_extended_tokenizer_path, verbose=False)
    assert tokenizer.base_vocab_size == 256 + 16 + 2
    assert specials["<|begin_of_text|>"] == 274
    assert tokenizer.vocab_size == 274 + 256 == 530


def test_dsu_tokenizes_to_single_token(tiny_extended_tokenizer_path):
    tokenizer, _ = setup_llama3_tokenizer(tiny_extended_tokenizer_path, verbose=False)
    for i in range(16):
        ids = tokenizer.encode(dsu2pua(i), add_bos=False, add_eos=False)
        assert ids == [256 + i], f"DSU {i} must tokenize 1:1, got {ids}"
    # a run of DSUs stays 1:1 (PUA regex splits each codepoint)
    span = "".join(dsu2pua(i) for i in [3, 3, 7, 1])
    assert tokenizer.encode(span, add_bos=False, add_eos=False) == [259, 259, 263, 257]


def test_modality_tokens_single(tiny_extended_tokenizer_path):
    tokenizer, _ = setup_llama3_tokenizer(tiny_extended_tokenizer_path, verbose=False)
    assert tokenizer.encode(MODALITY_TOKEN_TEXT, add_bos=False, add_eos=False) == [272]
    assert tokenizer.encode(MODALITY_TOKEN_SPEECH, add_bos=False, add_eos=False) == [273]


def test_mixed_text_dsu_roundtrip(tiny_extended_tokenizer_path):
    tokenizer, _ = setup_llama3_tokenizer(tiny_extended_tokenizer_path, verbose=False)
    text = "abc " + dsu2pua(0) + dsu2pua(5) + " xyz"
    ids = tokenizer.encode(text, add_bos=True, add_eos=True)
    assert ids[0] == tokenizer.bos_id and ids[-1] == tokenizer.eos_id
    assert tokenizer.decode(ids) == text


def test_extend_tiktoken_duplicate_rejected(tmp_path):
    path = write_tiny_tokenizer(tmp_path / "tok.model")
    extend_tiktoken(4, False, path, path)
    with pytest.raises(RuntimeError, match="already exists"):
        extend_tiktoken(4, False, path, path)  # same DSUs again -> duplicate


def test_extend_tiktoken_refuses_existing_output(tmp_path):
    src = write_tiny_tokenizer(tmp_path / "a.model")
    dst = write_tiny_tokenizer(tmp_path / "b.model")
    with pytest.raises(FileExistsError):
        extend_tiktoken(4, False, src, dst)


def test_dsu_pua_mapping_roundtrip():
    for i in [0, 1, 6399, 6400, 8191]:
        assert pua2dsu(dsu2pua(i)) == i
    assert dsu2pua(0) == ""
    assert dsu2pua(4999) == chr(0xE000 + 4999)


def test_tokenize_messages_masks(tiny_extended_tokenizer_path):
    tokenizer, _ = setup_llama3_tokenizer(tiny_extended_tokenizer_path, max_seq_len=64, verbose=False)
    msgs = [
        Message(role="user", content="abc", masked=True),
        Message(role="assistant", content="de", masked=False),
    ]
    tokens, mask = tokenizer.tokenize_messages(msgs)
    assert len(tokens) == len(mask)
    assert mask[0] is True  # BOS masked
    assert mask[-1] is True  # EOS masked
    assert not all(mask)  # assistant content unmasked

    # inference mode: no end tokens on the final message, no EOS
    tokens_inf, _ = tokenizer.tokenize_messages(
        [Message(role="user", content="abc", masked=True), Message(role="assistant", content="", masked=False)],
        add_end_tokens=False,
    )
    assert tokens_inf[-1] != tokenizer.eos_id
    assert tokens_inf[-1] != tokenizer.eot_id


def test_validate_messages_rules():
    with pytest.raises(ValueError):
        validate_messages([Message(role="user", content="hi")])
    with pytest.raises(ValueError):
        validate_messages([Message(role="assistant", content="hi"), Message(role="user", content="x")])
    with pytest.raises(ValueError):
        validate_messages(
            [
                Message(role="user", content="a"),
                Message(role="assistant", content="b"),
                Message(role="system", content="s"),
            ]
        )
    validate_messages([Message(role="user", content="a"), Message(role="assistant", content="b")])


def test_decode_truncates_at_eos_index_zero(tiny_extended_tokenizer_path):
    """Regression: EOS as the very first token must truncate to empty output."""
    tokenizer, _ = setup_llama3_tokenizer(tiny_extended_tokenizer_path, verbose=False)
    out = tokenizer.decode([tokenizer.eos_id, 65, 66], truncate_at_eos=True)
    assert out == ""
    # and EOS mid-sequence still truncates there
    assert tokenizer.decode([65, tokenizer.eos_id, 66], truncate_at_eos=True) == "A"


def test_setup_pattern_knob(tmp_path):
    """tokenizer.pattern config key: 'cl100k' loads the non-PUA-splitting
    pattern (compressed-DSU runs); default stays the PUA contract."""
    from tests import helpers

    from ssi_jax.tokenizer import CL100K_PATTERN, CL100K_PATTERN_PUA, setup_llama3_tokenizer

    path = helpers.write_tiny_tokenizer(tmp_path / "tokenizer.model")
    tok_default, _ = setup_llama3_tokenizer(path, verbose=False)
    assert tok_default.pattern == CL100K_PATTERN_PUA
    tok_comp, _ = setup_llama3_tokenizer(path, verbose=False, pattern="cl100k")
    assert tok_comp.pattern == CL100K_PATTERN
    # two adjacent DSU chars: one piece under cl100k, two under the PUA pattern
    s = ""
    assert len(tok_default.encode(s, add_bos=False, add_eos=False)) >= 2
    assert tok_comp.decode(tok_comp.encode(s, add_bos=False, add_eos=False),
                           truncate_at_eos=False, skip_special_tokens=False) == s
