"""HTTP serving layer: OpenAI-shaped completions over the paged engine
(the `vllm serve` role; ref reaches vLLM at scripts/generate.py:112-118).

Hermetic: binds an ephemeral localhost port, posts via urllib. Correctness
bar is the usual one — greedy outputs equal the naive sequential stream —
plus concurrency (parallel posts share the continuous-batching stream) and
the per-request max_tokens budget.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ssi_jax.generate.engine import SamplingParams
from ssi_jax.models.llama3 import init_params
from ssi_jax.serve import Server, run_http_server
from tests import helpers
from tests.test_paged_decode import make_engine, naive_greedy


@pytest.fixture(scope="module")
def setup():
    cfg = helpers.tiny_config()
    params = init_params(cfg, jax.random.key(7), dtype=jnp.float32)
    return cfg, params


@pytest.fixture()
def server(setup):
    cfg, params = setup
    engine = make_engine(params, cfg, n_slots=3, max_context=64)
    sp = SamplingParams(temperature=0.0, max_tokens=8, stop_token_ids=())
    srv = Server(engine, sp, model_id="tiny-test")
    srv.start()
    httpd = run_http_server(srv, host="127.0.0.1", port=0)  # ephemeral port
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield srv, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    srv.stop()


def _post(url, path, body):
    req = urllib.request.Request(
        url + path, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as r:
        return r.status, json.loads(r.read())


def test_health_models_metrics(server):
    _srv, url = server
    code, body = _get(url, "/health")
    assert code == 200 and body["status"] == "ok"
    code, body = _get(url, "/v1/models")
    assert code == 200 and body["data"][0]["id"] == "tiny-test"
    code, body = _get(url, "/metrics")
    assert code == 200 and "n_pages" in body


def test_completions_greedy_matches_naive(setup, server):
    cfg, params = setup
    _srv, url = server
    rng = np.random.default_rng(91)
    prompt = rng.integers(1, cfg.vocab_size - 1, 12).tolist()
    code, body = _post(url, "/v1/completions", {"prompt": prompt})
    assert code == 200
    assert body["object"] == "text_completion"
    choice = body["choices"][0]
    assert choice["token_ids"] == naive_greedy(params, cfg, prompt, 8)
    assert choice["finish_reason"] == "length"
    assert body["usage"]["prompt_tokens"] == 12
    assert body["usage"]["completion_tokens"] == 8


def test_completions_concurrent(setup, server):
    """Parallel posts ride ONE continuous-batching stream; every response is
    the request's own greedy stream."""
    cfg, params = setup
    _srv, url = server
    rng = np.random.default_rng(97)
    prompts = [rng.integers(1, cfg.vocab_size - 1, int(n)).tolist() for n in [5, 9, 14, 7, 11, 3]]
    results = [None] * len(prompts)

    def go(i):
        results[i] = _post(url, "/v1/completions", {"prompt": prompts[i]})

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, prompt in enumerate(prompts):
        code, body = results[i]
        assert code == 200, (i, body)
        assert body["choices"][0]["token_ids"] == naive_greedy(params, cfg, prompt, 8), i


def test_per_request_max_tokens(setup, server):
    cfg, params = setup
    _srv, url = server
    rng = np.random.default_rng(101)
    prompt = rng.integers(1, cfg.vocab_size - 1, 10).tolist()
    code, body = _post(url, "/v1/completions", {"prompt": prompt, "max_tokens": 3})
    assert code == 200
    assert body["choices"][0]["token_ids"] == naive_greedy(params, cfg, prompt, 3)
    # above the stream budget -> clean 400, server keeps serving
    code, body = _post(url, "/v1/completions", {"prompt": prompt, "max_tokens": 99})
    assert code == 400 and "max_tokens" in body["error"]["message"]
    code, body = _post(url, "/v1/completions", {"prompt": prompt})
    assert code == 200


def test_invalid_requests(server):
    _srv, url = server
    code, body = _post(url, "/v1/completions", {"prompt": "text needs a tokenizer"})
    assert code == 400 and "tokenizer" in body["error"]["message"]
    code, body = _post(url, "/v1/completions", {"prompt": {"bad": 1}})
    assert code == 400
    code, body = _post(url, "/v1/completions", {"prompt": []})
    assert code == 400
    code, body = _post(url, "/nope", {})
    assert code == 404


def test_streaming_completion(setup, server):
    """stream=true: SSE events deliver token deltas incrementally; their
    concatenation equals the naive greedy stream and the final record carries
    finish_reason + usage."""
    cfg, params = setup
    _srv, url = server
    rng = np.random.default_rng(103)
    prompt = rng.integers(1, cfg.vocab_size - 1, 9).tolist()
    req = urllib.request.Request(
        url + "/v1/completions",
        data=json.dumps({"prompt": prompt, "stream": True}).encode(),
        headers={"Content-Type": "application/json"},
    )
    events = []
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        while True:
            line = r.readline().decode()
            if not line:
                break
            line = line.strip()
            if not line.startswith("data: "):
                continue
            payload = line[len("data: "):]
            if payload == "[DONE]":
                break
            events.append(json.loads(payload))
    assert len(events) >= 2  # at least one delta + the final record
    final = events[-1]
    assert final["choices"][0]["finish_reason"] == "length"
    got = [t for e in events[:-1] for t in e["choices"][0]["token_ids"]]
    assert got == naive_greedy(params, cfg, prompt, 8)
    assert final["usage"]["completion_tokens"] == 8


def test_server_survives_engine_error(setup, server):
    """An engine-step failure fails the in-flight requests with a clean error
    and restarts the stream — later requests are served normally."""
    cfg, params = setup
    srv, url = server
    real_step = srv.engine.step
    state = {"armed": True}

    def flaky_step():
        if state["armed"]:
            state["armed"] = False
            srv.engine.end_stream()  # mimic step()'s release-everything-on-raise
            raise RuntimeError("injected fault")
        return real_step()

    srv.engine.step = flaky_step
    rng = np.random.default_rng(107)
    prompt = rng.integers(1, cfg.vocab_size - 1, 7).tolist()
    code, body = _post(url, "/v1/completions", {"prompt": prompt})
    assert code == 400 and "engine error" in body["error"]["message"]
    code, body = _post(url, "/v1/completions", {"prompt": prompt})
    assert code == 200
    assert body["choices"][0]["token_ids"] == naive_greedy(params, cfg, prompt, 8)


def test_per_request_sampling_http(setup, server):
    """OpenAI per-request sampling fields: top_k=1 sampling equals greedy,
    seeded sampling is reproducible, n>1 returns n choices."""
    cfg, params = setup
    _srv, url = server
    rng = np.random.default_rng(113)
    prompt = rng.integers(1, cfg.vocab_size - 1, 9).tolist()
    want = naive_greedy(params, cfg, prompt, 8)

    code, body = _post(url, "/v1/completions",
                       {"prompt": prompt, "temperature": 0.9, "top_k": 1})
    assert code == 200
    assert body["choices"][0]["token_ids"] == want

    a = _post(url, "/v1/completions", {"prompt": prompt, "temperature": 1.0, "seed": 5})
    b = _post(url, "/v1/completions", {"prompt": prompt, "temperature": 1.0, "seed": 5})
    c = _post(url, "/v1/completions", {"prompt": prompt, "temperature": 1.0, "seed": 6})
    assert a[0] == b[0] == c[0] == 200
    assert a[1]["choices"][0]["token_ids"] == b[1]["choices"][0]["token_ids"]
    assert c[1]["choices"][0]["token_ids"] != a[1]["choices"][0]["token_ids"]

    code, body = _post(url, "/v1/completions", {"prompt": prompt, "n": 2})
    assert code == 200
    assert len(body["choices"]) == 2
    for ch in body["choices"]:
        assert ch["token_ids"] == want


def test_per_request_feature_rejected_http(setup, server):
    """Penalty params need the opt-in "pen" branch; the default server
    rejects them with a 400 instead of recompiling mid-serve."""
    cfg, _params = setup
    _srv, url = server
    rng = np.random.default_rng(117)
    prompt = rng.integers(1, cfg.vocab_size - 1, 6).tolist()
    code, body = _post(url, "/v1/completions",
                       {"prompt": prompt, "repetition_penalty": 1.3})
    assert code == 400
    assert "features" in body["error"]["message"]
    # the stream survives the rejection
    code, _body = _post(url, "/v1/completions", {"prompt": prompt})
    assert code == 200


class _LetterTokenizer:
    """Deterministic 1-token -> 1-ASCII-letter decode for exact stop-string
    assertions (a real byte-level tokenizer's decode is not prefix-stable
    across multi-byte boundaries, which is exactly what the char-exact
    truncation handles — tested separately via the chat server)."""

    def decode(self, ids):
        return "".join(chr(97 + (t % 26)) for t in ids)


@pytest.fixture()
def stop_server(setup):
    cfg, params = setup
    engine = make_engine(params, cfg, n_slots=3, max_context=64)
    sp = SamplingParams(temperature=0.0, max_tokens=8, stop_token_ids=())
    srv = Server(engine, sp, tokenizer=_LetterTokenizer(), model_id="tiny-stop")
    srv.start()
    httpd = run_http_server(srv, host="127.0.0.1", port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield srv, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    srv.stop()


def test_stop_strings(setup, stop_server):
    """OpenAI `stop`: generation ends at the first match, the match itself is
    excluded from the text, token_ids are the shortest prefix containing it."""
    cfg, params = setup
    _srv, url = stop_server
    rng = np.random.default_rng(131)
    prompt = rng.integers(1, cfg.vocab_size - 1, 10).tolist()
    full = naive_greedy(params, cfg, prompt, 8)
    full_text = _LetterTokenizer().decode(full)
    stop = full_text[3:5]
    idx = full_text.index(stop)

    code, body = _post(url, "/v1/completions", {"prompt": prompt, "stop": stop})
    assert code == 200
    choice = body["choices"][0]
    assert choice["finish_reason"] == "stop"
    assert choice["text"] == full_text[:idx]
    assert stop not in choice["text"]
    assert choice["token_ids"] == full[: idx + len(stop)]

    # a list of stops: the earliest match wins
    code, body = _post(url, "/v1/completions",
                       {"prompt": prompt, "stop": ["zzzz", stop]})
    assert code == 200 and body["choices"][0]["text"] == full_text[:idx]

    # a never-matching stop runs to the budget
    code, body = _post(url, "/v1/completions", {"prompt": prompt, "stop": "ZZZ"})
    assert code == 200
    assert body["choices"][0]["finish_reason"] == "length"
    assert body["choices"][0]["token_ids"] == full

    # invalid shapes reject cleanly
    code, body = _post(url, "/v1/completions", {"prompt": prompt, "stop": [1]})
    assert code == 400
    code, body = _post(url, "/v1/completions", {"prompt": prompt, "stop": "x", "n": 2})
    assert code == 400


def test_stop_strings_stream(setup, stop_server):
    """Streamed stop: held-back deltas never leak the stop string; the
    concatenated text ends char-exactly at the match."""
    cfg, params = setup
    _srv, url = stop_server
    rng = np.random.default_rng(137)
    prompt = rng.integers(1, cfg.vocab_size - 1, 11).tolist()
    full_text = _LetterTokenizer().decode(naive_greedy(params, cfg, prompt, 8))
    stop = full_text[4:6]
    idx = full_text.index(stop)

    req = urllib.request.Request(
        url + "/v1/completions",
        data=json.dumps({"prompt": prompt, "stop": stop, "stream": True}).encode(),
        headers={"Content-Type": "application/json"},
    )
    events = []
    with urllib.request.urlopen(req, timeout=120) as r:
        while True:
            line = r.readline().decode().strip()
            if not line.startswith("data: "):
                continue
            payload = line[len("data: "):]
            if payload == "[DONE]":
                break
            events.append(json.loads(payload))
    assert events[-1]["choices"][0]["finish_reason"] == "stop"
    text = "".join(e["choices"][0].get("text", "") for e in events[:-1])
    assert text == full_text[:idx]
    assert stop not in text


def test_logprobs_openai_shape(setup, stop_server):
    """`logprobs` in the request returns the OpenAI logprobs object: one
    chosen-token logprob per emitted token, tokens + text offsets aligned."""
    cfg, params = setup
    _srv, url = stop_server
    rng = np.random.default_rng(149)
    prompt = rng.integers(1, cfg.vocab_size - 1, 8).tolist()
    code, body = _post(url, "/v1/completions", {"prompt": prompt, "logprobs": 1})
    assert code == 200
    choice = body["choices"][0]
    lp = choice["logprobs"]
    n = len(choice["token_ids"])
    assert len(lp["token_logprobs"]) == n == len(lp["tokens"]) == len(lp["text_offset"])
    assert all(x <= 0.0 for x in lp["token_logprobs"])
    assert sum(lp["token_logprobs"]) == pytest.approx(choice["cumulative_logprob"], abs=1e-4)
    assert "".join(lp["tokens"]) == choice["text"]
    assert lp["text_offset"] == [len("".join(lp["tokens"][:i])) for i in range(n)]
    # absent from the response when not requested
    code, body = _post(url, "/v1/completions", {"prompt": prompt})
    assert code == 200 and "logprobs" not in body["choices"][0]


def test_stream_disconnect_aborts(setup):
    """server.cancel (the disconnect path) frees the slot and finalizes the
    request with finish_reason=abort; the server keeps serving. Uses a long
    budget so the cancel lands mid-run, not after natural completion."""
    cfg, params = setup
    engine = make_engine(params, cfg, n_slots=2, max_context=64)
    sp = SamplingParams(temperature=0.0, max_tokens=48, stop_token_ids=())
    srv = Server(engine, sp, tokenizer=_LetterTokenizer(), model_id="tiny-abort")
    srv.start()
    try:
        rng = np.random.default_rng(139)
        prompt = rng.integers(1, cfg.vocab_size - 1, 9).tolist()
        pend = srv.submit_stream(prompt, None)
        first = pend.deltas.get(timeout=60)  # at least one delta arrived
        assert isinstance(first, list) and first
        srv.cancel(pend)
        assert pend.event.wait(timeout=60)
        assert pend.outputs is not None
        assert pend.outputs[0]["finish_reason"] == "abort"
        # drain the sentinel; then the engine is fully reusable
        while pend.deltas.get(timeout=10) is not None:
            pass
        done = srv.submit(prompt, 5)
        assert done.error is None
        assert done.outputs[0]["token_ids"] == naive_greedy(params, cfg, prompt, 5)
    finally:
        srv.stop()


@pytest.fixture()
def chat_server(setup, tmp_path):
    """Server with a real (tiny, DSU-extended) tokenizer for chat endpoints."""
    from ssi_jax.extend import extend_tiktoken
    from ssi_jax.tokenizer import setup_llama3_tokenizer

    cfg, params = setup
    tok_path = tmp_path / "tokenizer.model"
    helpers.write_tiny_tokenizer(tok_path)
    extend_tiktoken(cfg.n_dsus, cfg.modality_tokens, tok_path, tok_path)
    tokenizer, _special = setup_llama3_tokenizer(tok_path, verbose=False)
    engine = make_engine(params, cfg, n_slots=3, max_context=64)
    sp = SamplingParams(temperature=0.0, max_tokens=8, stop_token_ids=tuple(tokenizer.stop_tokens))
    srv = Server(engine, sp, tokenizer=tokenizer, model_id="tiny-chat")
    srv.start()
    httpd = run_http_server(srv, host="127.0.0.1", port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield srv, tokenizer, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    srv.stop()


def test_chat_completions(setup, chat_server):
    """/v1/chat/completions renders the Llama-3 chat format (SFT inference
    construction) and returns an OpenAI chat.completion; token_ids equal the
    naive greedy stream over the rendered prompt."""
    from ssi_jax.serve import _chat_prompt_tokens

    cfg, params = setup
    _srv, tokenizer, url = chat_server
    messages = [
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": "hi"},
    ]
    code, body = _post(url, "/v1/chat/completions", {"messages": messages})
    assert code == 200
    assert body["object"] == "chat.completion"
    choice = body["choices"][0]
    assert choice["message"]["role"] == "assistant"
    assert isinstance(choice["message"]["content"], str)
    rendered = _chat_prompt_tokens(tokenizer, messages)
    want = naive_greedy(params, cfg, rendered, 8)
    stops = set(tokenizer.stop_tokens)
    if any(t in stops for t in want):  # engine stops at the first stop token
        k = next(i for i, t in enumerate(want) if t in stops)
        want = want[: k + 1]
    assert choice["token_ids"] == want
    assert body["usage"]["prompt_tokens"] == len(rendered)


def test_chat_completions_stream(chat_server):
    """stream=true emits chat.completion.chunk deltas: role first, content
    deltas, a finish_reason chunk with usage, then [DONE]."""
    import urllib.request as _ur

    _srv, _tokenizer, url = chat_server
    req = _ur.Request(
        url + "/v1/chat/completions",
        data=json.dumps({"messages": [{"role": "user", "content": "go"}],
                         "stream": True, "max_tokens": 4}).encode(),
        headers={"Content-Type": "application/json"},
    )
    events = []
    with _ur.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            payload = line[len("data: "):]
            if payload == "[DONE]":
                break
            events.append(json.loads(payload))
    assert events[0]["object"] == "chat.completion.chunk"
    assert events[0]["choices"][0]["delta"] == {"role": "assistant"}
    final = events[-1]
    assert final["choices"][0]["finish_reason"] in ("stop", "length")
    assert final["usage"]["completion_tokens"] >= 1
    got = [t for e in events[1:-1] for t in e["choices"][0]["token_ids"]]
    assert len(got) == final["usage"]["completion_tokens"]


def test_chat_completions_validation(server, chat_server):
    """Bad chat requests 400 cleanly: no tokenizer, empty messages, assistant
    last, unknown role."""
    _srv, url = server  # tokenizer-less server
    code, body = _post(url, "/v1/chat/completions",
                       {"messages": [{"role": "user", "content": "x"}]})
    assert code == 400 and "tokenizer" in body["error"]["message"]
    _srv2, _tok, churl = chat_server
    for bad in (
        {"messages": []},
        {"messages": [{"role": "assistant", "content": "x"}]},
        {"messages": [{"role": "tool", "content": "x"}]},
        {"messages": [{"role": "user", "content": 3}]},
    ):
        code, body = _post(churl, "/v1/chat/completions", bad)
        assert code == 400, bad


def test_start_surfaces_begin_stream_error(setup):
    """A scheduler thread that dies in begin_stream must raise from start(),
    not leave it waiting on the started-event forever."""
    cfg, params = setup
    engine = make_engine(params, cfg, speculate_k=2)  # greedy-only mode
    sp = SamplingParams(temperature=0.7, max_tokens=4, stop_token_ids=())
    srv = Server(engine, sp, model_id="bad")
    with pytest.raises(ValueError, match="greedy"):
        srv.start()


def test_incremental_decoder_repairs_split_utf8():
    """A multi-byte character split across two deltas streams as the real
    character once complete, never as U+FFFD mojibake."""
    from ssi_jax.serve import _IncrementalDecoder

    class ByteTok:
        def decode(self, ids):
            return bytes(ids).decode("utf-8", errors="replace")

    dec = _IncrementalDecoder(ByteTok())
    payload = "héllo 🦜!".encode()
    # worst case: one byte per delta
    text = "".join(dec.push([b]) for b in payload)
    assert text == "héllo 🦜!"
    # split exactly at the emoji's 4-byte boundary, two bytes per delta
    dec2 = _IncrementalDecoder(ByteTok())
    chunks = [list(payload[i : i + 2]) for i in range(0, len(payload), 2)]
    text2 = "".join(dec2.push(c) for c in chunks)
    assert text2 == "héllo 🦜!"
    # genuinely invalid trailing byte stays held back (OpenAI convention)
    dec3 = _IncrementalDecoder(ByteTok())
    assert dec3.push(list("ab".encode()) + [0xFF]) == "ab"


def test_submit_timeout_cancels_request(setup):
    """A timed-out submit frees the engine slot instead of decoding the full
    budget for a dead client."""
    cfg, params = setup
    engine = make_engine(params, cfg, n_slots=2, max_context=64)
    sp = SamplingParams(temperature=0.0, max_tokens=40, stop_token_ids=())
    srv = Server(engine, sp, model_id="t")
    srv.start()
    try:
        pend = srv.submit([1, 2, 3], None, timeout_s=0.0)  # expires immediately
        assert pend.error == "timed out"
        # the scheduler must cancel it and return the slot + pages
        for _ in range(100):
            if all(s.req is None for s in engine._slots) and not srv._q.qsize():
                break
            import time as _t

            _t.sleep(0.05)
        assert all(s.req is None for s in engine._slots)
        assert len(engine._free_pages) + len(engine._cache_lru) == engine.n_pages
    finally:
        srv.stop()
