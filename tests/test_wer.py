"""First-party WER + normalizer tests (ref: scripts/wer.py:59-73 behavior)."""

import pytest

from ssi_jax.eval import english_normalizer, word_error_rate


def test_wer_exact_match():
    assert word_error_rate(["hello world"], ["hello world"]) == 0.0


def test_wer_known_values():
    # 1 substitution over 2 ref words
    assert word_error_rate(["hello world"], ["hello there"]) == pytest.approx(0.5)
    # 1 deletion over 3
    assert word_error_rate(["a b c"], ["a c"]) == pytest.approx(1 / 3)
    # 1 insertion over 2
    assert word_error_rate(["a b"], ["a x b"]) == pytest.approx(0.5)
    # WER can exceed 1.0 (all insertions)
    assert word_error_rate(["a"], ["x y z"]) == pytest.approx(3.0)


def test_wer_corpus_level_pooling():
    # corpus WER pools edits and ref lengths across samples (jiwer semantics),
    # NOT the mean of per-sample WERs
    refs = ["a b c d e f g h i j", "a"]
    hyps = ["a b c d e f g h i j", "x"]
    assert word_error_rate(refs, hyps) == pytest.approx(1 / 11)


def test_wer_empty_hypothesis():
    assert word_error_rate(["a b c"], [""]) == pytest.approx(1.0)


def test_wer_validates_lengths():
    with pytest.raises(ValueError, match="Length mismatch"):
        word_error_rate(["a"], ["a", "b"])
    with pytest.raises(ValueError, match="zero"):
        word_error_rate([""], [""])


def test_whisper_normalizer_canonicalizes():
    normalize = english_normalizer()
    assert normalize("Hello, World!") == "hello world"
    # contractions and abbreviations standardized
    assert normalize("I won't go") == "i will not go"
    assert normalize("Mr. Smith") == "mister smith"
    # numbers normalized to digits
    assert normalize("twenty one dollars") == "$21"


def test_normalized_wer_pipeline():
    normalize = english_normalizer()
    refs = [normalize("Hello, World!")]
    hyps = [normalize("hello world")]
    assert word_error_rate(refs, hyps) == 0.0


def test_spelling_mapping_vendored():
    """The vendored British->American mapping is loaded by default and applied
    whole-word after normalization."""
    from ssi_jax.eval import load_spelling_mapping

    mapping = load_spelling_mapping()
    assert len(mapping) > 900
    # whole-word, lowercase, non-identity entries only
    assert all(k == k.lower() and " " not in k and k != v for k, v in mapping.items())

    normalize = english_normalizer()
    # differential fixtures: frozen expected outputs of the full normalizer
    fixtures = [
        ("The colour of the theatre was analysed.", "the color of the theater was analyzed"),
        ("My neighbour's behaviour was marvellous!", "my neighbor is behavior was marvelous"),
        ("He travelled to the centre to practise.", "he traveled to the center to practice"),
        ("A grey aluminium tyre on the kerb.", "a gray aluminum tire on the curb"),
        ("They organised a programme for the labourers.", "they organized a program for the laborers"),
        # words that must NOT be touched (substring traps for the -our class)
        ("four hours on tour", "4 hours on tour"),
        ("this is ours", "this is ours"),
    ]
    for raw, expected in fixtures:
        assert normalize(raw) == expected

    # spelling can be disabled by passing an explicit empty mapping
    plain = english_normalizer({})
    assert plain("colour") == "colour"


def test_normalizer_adversarial_goldens():
    """Frozen outputs of the full normalizer on adversarial inputs — numbers,
    currency, abbreviations, contractions, disfluencies.

    Expected strings were generated from transformers' vendored
    EnglishTextNormalizer, which is Whisper's implementation verbatim (the
    reference consumes the same algorithm through the whisper_normalizer
    package, ref: scripts/wer.py:61-64) — including its published quirks
    ("O'Brien" -> "0 brien", "ten o'clock" -> "100 clock", bare "pounds" ->
    currency): bug-for-bug equality is the parity contract, so a change in
    any of these means WER drift vs the reference.
    """
    normalize = english_normalizer()
    goldens = [
        # numbers
        ("one hundred and twenty three people", "123 people"),
        ("the third of March, nineteen eighty-four", "the 3rd of march 1984"),
        ("one million two hundred thirty four thousand five hundred sixty seven", "1234567"),
        ("two thousand and one", "2001"),
        ("1st 2nd 3rd 21st 102nd", "1st 2nd 3rd 21st 102nd"),
        ("twenty-first century, the 1970s, and the '90s", "21st century the 1970s and the 90s"),
        ("ninety-nine point nine percent", "99.9%"),
        ("minus five degrees, plus three", "-5 degrees +3"),
        ("seven eighths of an inch", "7 eighths of an inch"),
        # currency
        ("It costs five dollars and fifty cents.", "it costs $5.50"),
        ("He paid £3.50 for two and a half kilos.", "he paid £3.50 for 2.5 kilos"),
        ("three pounds of flour", "£3 of flour"),  # upstream quirk: mass noun coerced to currency
        # abbreviations + possessives
        ("Dr. Jones met Mrs. O'Brien at St. Mary's.", "doctor jones met missus 0 brien at saint mary is"),
        ("number one and No. 2", "number one and no 2"),
        # contractions
        ("I can't, shouldn't, and won't do it; they're gonna leave.",
         "i can not should not and will not do it they are going to leave"),
        ("He's got 'em, ain't he?", "he has got em aint he"),
        ("a half past ten o'clock", "a half past 100 clock"),  # upstream quirk
        # hyphen splitting + disfluency removal
        ("double-decker bus re-enactment co-operate", "double decker bus re enactment co operate"),
        ("umm, uh, hmm, you know, like, actually", "umm you know like actually"),
    ]
    for raw, expected in goldens:
        assert normalize(raw) == expected, raw


def test_spelling_map_generator_in_sync():
    """tools/gen_spelling_map.py --check: the committed JSON must be exactly
    what the generator produces (reviewability of the 2k-entry asset)."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, str(root / "tools" / "gen_spelling_map.py"), "--check"],
        capture_output=True, text=True,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_spelling_map_scale_and_classes():
    """Coverage floor: >=1.6k entries, with every
    morphological class represented."""
    from ssi_jax.eval import load_spelling_mapping

    m = load_spelling_mapping()
    assert len(m) >= 1600
    for brit, amer in [
        ("characterise", "characterize"), ("characterisation", "characterization"),
        ("paralyse", "paralyze"), ("unfavourable", "unfavorable"),
        ("amphitheatre", "amphitheater"), ("gynaecologist", "gynecologist"),
        ("counsellor", "counselor"), ("fulfilment", "fulfillment"),
        ("defenceless", "defenseless"), ("catalogued", "cataloged"),
        ("manoeuvring", "maneuvering"), ("tranquillity", "tranquility"),
        ("draughtsmanship", "draftsmanship"),
    ]:
        assert m.get(brit) == amer, (brit, m.get(brit))
    # words identical in both dialects must NOT be present
    for both in ["advertise", "disenfranchise", "surprise", "compromise", "televise"]:
        assert both not in m, both


def test_suspected_unmapped_words():
    """Residual-divergence counter: post-normalization words
    that look British-spelled but are absent from the vendored map."""
    from ssi_jax.eval.wer import (
        load_spelling_mapping,
        spelling_mapping_fingerprint,
        suspected_unmapped_words,
    )

    m = load_spelling_mapping()
    # every mapped word is by definition not a gap
    assert suspected_unmapped_words([" ".join(m.keys())], m) == {}
    # synthetic gaps in each class are caught and counted
    gaps = suspected_unmapped_words(
        ["he zzzourised the quxxtre twice while zzzising", "zzzourised gooelled rrhoea"], m
    )
    assert gaps["zzzourised"] == 2
    assert {"quxxtre", "zzzising", "gooelled", "rrhoea"} <= set(gaps)
    # common words identical in American English are NOT suspects
    clean = suspected_unmapped_words(
        ["four hours on tour with flour and a promise to exercise surprise",
         "compelled spelling across the acre in vogue analyzing dwelling"], m
    )
    assert clean == {}, clean

    fp = spelling_mapping_fingerprint(m)
    assert fp["spelling_map_entries"] == len(m)
    assert len(fp["spelling_map_sha256"]) == 64


def test_normalizer_class_boundary_goldens():
    """Every systematic spelling-map class exercised at its boundary: one mapped
    word AND one identical-in-US neighbour per class, through the FULL
    normalizer."""
    normalize = english_normalizer()
    cases = [
        # (-ise class, and an -ise word that must survive)
        ("they recognise and advertise", "they recognize and advertise"),
        ("she apologised, he will exercise", "she apologized he will exercise"),
        # -yse
        ("paralysed while they analyse", "paralyzed while they analyze"),
        # -our vs identical -our
        ("the labour of four hours", "the labor of 4 hours"),
        ("rumour has it our flour is sour", "rumor has it our flour is sour"),
        # -re vs identical -re
        ("the theatre near the acre", "the theater near the acre"),
        ("a litre of lucre at the centre", "a liter of lucre at the center"),
        # doubled-l vs stressed-syllable ll
        ("he travelled and was compelled", "he traveled and was compelled"),
        ("modelling while propelling", "modeling while propelling"),
        # -ence vs -ense
        ("the defence of the licence", "the defense of the license"),
        # -ogue vs identical
        ("a catalogue in vogue", "a catalog in vogue"),
        # ae/oe reduction
        ("anaemia near the phoenix", "anemia near the phoenix"),
    ]
    for raw, expected in cases:
        assert normalize(raw) == expected, raw


def test_wer_parity_harness(tmp_path):
    """scripts/wer_parity.py end-to-end offline: scores an existing generations
    dir against local refs and emits the reference-comparable artifact."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    gen_dir = tmp_path / "mls-hubert" / "dev"
    gen_dir.mkdir(parents=True)
    rows = [
        {"prompt": "p", "outputs": [{"text": "the colour of the theatre was analysed"}]},
        {"prompt": "p", "outputs": [{"text": "he travelled to the centre"}]},
    ]
    with open(gen_dir / "generations.jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    refs = tmp_path / "refs.jsonl"
    with open(refs, "w") as f:
        f.write(json.dumps({"transcript": "The color of the theater was analyzed."}) + "\n")
        f.write(json.dumps({"transcript": "he traveled to the center"}) + "\n")

    proc = subprocess.run(
        [sys.executable, str(root / "scripts" / "wer_parity.py"),
         "--skip-generate", str(gen_dir), "--refs-jsonl", str(refs)],
        capture_output=True, text=True, env={"PYTHONPATH": str(root), "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    art = json.loads((gen_dir / "wer_parity.json").read_text())
    assert art["wer"] == 0.0  # identical after normalization
    assert art["spelling_map_entries"] >= 1600
    assert art["dataset"] == "mls-hubert" and art["split"] == "dev"

    # delta mode against a (synthetic) reference wer.json
    ref_wer = tmp_path / "wer.json"
    ref_wer.write_text(json.dumps({"wer": 0.05}))
    (gen_dir / "wer_parity.json").unlink()
    proc = subprocess.run(
        [sys.executable, str(root / "scripts" / "wer_parity.py"),
         "--skip-generate", str(gen_dir), "--refs-jsonl", str(refs),
         "--reference-wer", str(ref_wer)],
        capture_output=True, text=True, env={"PYTHONPATH": str(root), "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    art = json.loads((gen_dir / "wer_parity.json").read_text())
    assert art["wer_delta"] == pytest.approx(0.05)
    assert art["within_target"] is True
