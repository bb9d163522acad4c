"""The port's scoring server (``intrepppid_tpu_torch/serve``, ``cli``) on the
CPU against the JAX package's ``ScoringEngine`` with identical weights, with
the setup of ``tests/test_serve.py``: the HTTP endpoints and their errors,
and ``serve start --device cpu`` in-process."""
import io
import json
import threading
import time
import urllib.error
import urllib.request
from contextlib import redirect_stdout
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from intrepppid_tpu.data.tokenizer import SentencePieceTokenizer as JaxTokenizer
from intrepppid_tpu.models.factory import intrepppid_network as jax_network
from intrepppid_tpu.serve import ScoringEngine as JaxEngine
from intrepppid_tpu.utils.torch_convert import save_torch_checkpoint
from intrepppid_tpu_torch.cli.serve import Serve
from intrepppid_tpu_torch.data.tokenizer import SentencePieceTokenizer
from intrepppid_tpu_torch.models.factory import intrepppid_network
from intrepppid_tpu_torch.serve import CoalescingScorer, PPIServer, ScoringEngine
from intrepppid_tpu_torch.utils.convert import from_jax_params
from torch_port_threads import one_thread_one_cpu  # noqa: F401  (autouse)

FIXTURES = Path(__file__).parent / "fixtures"
SPM = FIXTURES / "tiny_spm.model"
TRUNC = 200  # default_buckets(200) == [128, 200]
VOCAB = 38
EMBED = 16
AAS = "ACDEFGHIKLMNPQRSTVWY"


def _mk_seq(rng, n):
    return "".join(rng.choice(list(AAS), n))


def _pairs(seed, n):
    rng = np.random.default_rng(seed)
    out = [(_mk_seq(rng, 10 + 7 * i), _mk_seq(rng, 40 - 3 * i)) for i in range(n - 1)]
    return out + [(_mk_seq(rng, 190), _mk_seq(rng, 150))]  # the 200 bucket


@pytest.fixture(scope="module")
def served():
    jnet = jax_network(0, vocab_size=VOCAB, embedding_size=EMBED, rnn_num_layers=2,
                       use_projection=True)
    params = jax.tree_util.tree_map(np.array, jnet.init(jax.random.PRNGKey(3)))
    net = intrepppid_network(0, vocab_size=VOCAB, embedding_size=EMBED,
                             use_projection=True, device="cpu")
    engine = ScoringEngine(net, from_jax_params(params), SentencePieceTokenizer(SPM),
                           trunc_len=TRUNC, batch_size=4, bulk_batch_size=0)
    return jnet, params, engine


@pytest.mark.parametrize("batch,bulk", [(4, 0), (2, 5)])
def test_engine_matches_jax_engine(served, batch, bulk):
    """Bucketed, chunked, repeat-padded scores equal the JAX engine's, with
    the bulk ladder off and on."""
    jnet, params, _ = served
    net = intrepppid_network(0, vocab_size=VOCAB, embedding_size=EMBED,
                             use_projection=True, device="cpu")
    engine = ScoringEngine(net, from_jax_params(params), SentencePieceTokenizer(SPM),
                           trunc_len=TRUNC, batch_size=batch, bulk_batch_size=bulk)
    ref = JaxEngine(jnet, params, JaxTokenizer(SPM), trunc_len=TRUNC,
                    batch_size=batch, bulk_batch_size=bulk)
    pairs = _pairs(0, 7)
    got = engine.score_pairs(pairs)
    assert got.shape == (7,) and got.dtype == np.float32
    assert np.all((got > 0) & (got < 1))
    np.testing.assert_allclose(got, ref.score_pairs(pairs), atol=2e-5, rtol=0)
    assert engine.score_pairs([]).shape == (0,)


def test_engine_batch_ladder_and_cache(served):
    _, params, engine = served
    net = intrepppid_network(0, vocab_size=VOCAB, embedding_size=EMBED,
                             use_projection=True, device="cpu")
    ladder = ScoringEngine(net, from_jax_params(params), SentencePieceTokenizer(SPM),
                           trunc_len=TRUNC, batch_size=2, bulk_batch_size=5)
    shapes = []
    inner = ladder._probs

    def spy(xa, xb):
        shapes.append(xa.shape)
        return inner(xa, xb)

    ladder._probs = spy
    pairs = _pairs(11, 7)
    probs = ladder.score_pairs(pairs)
    # one bulk chunk of 5, then the 2-pair tail at the small shape; the
    # tail holds the 190-residue pair, so it takes the 200 bucket
    assert [s[0] for s in shapes] == [5, 2] and shapes[1][1] == TRUNC
    np.testing.assert_allclose(probs, engine.score_pairs(pairs), atol=1e-6, rtol=0)
    # the second scoring rides the token cache and is bitwise identical
    np.testing.assert_array_equal(ladder.score_pairs(pairs), probs)
    assert ScoringEngine(net, None, SentencePieceTokenizer(SPM), trunc_len=TRUNC,
                         batch_size=4, bulk_batch_size=2).bulk_batch_size == 4
    ladder.warmup()
    assert ladder.preload((f"s{i}", a) for i, (a, _) in enumerate(pairs)) == 7


def test_engine_guards_and_swap(served):
    jnet, params, engine = served
    small = intrepppid_network(0, vocab_size=20, embedding_size=8, device="cpu")
    with pytest.raises(ValueError, match="vocab_size"):
        ScoringEngine(small, None, engine.spp, trunc_len=32, batch_size=2)
    with pytest.raises(NotImplementedError, match="one card"):
        ScoringEngine(engine.net, None, engine.spp, n_data_parallel=2)
    pairs = _pairs(31, 2)
    before = engine.score_pairs(pairs)
    other = jax.tree_util.tree_map(np.array, jnet.init(jax.random.PRNGKey(99)))
    engine.swap_params(from_jax_params(other))
    assert not np.array_equal(engine.score_pairs(pairs), before)
    engine.swap_params(from_jax_params(params))
    np.testing.assert_array_equal(engine.score_pairs(pairs), before)


def test_coalescing_merges_concurrent_requests(served):
    _, _, engine = served
    gate, entered, calls = threading.Event(), threading.Event(), []

    class Gated:
        def score_pairs(self, pairs):
            calls.append(len(pairs))
            if len(calls) == 1:
                entered.set()
                assert gate.wait(timeout=30)
            return engine.score_pairs(pairs)

    scorer = CoalescingScorer(Gated())
    reqs = [_pairs(40 + i, 1) for i in range(4)]
    results = {}
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, scorer.submit(reqs[i])))
               for i in range(4)]
    try:
        threads[0].start()
        assert entered.wait(timeout=30)
        for t in threads[1:]:
            t.start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            with scorer._cv:
                if len(scorer._queue) == 3:
                    break
            time.sleep(0.01)
        gate.set()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert calls == [1, 3]
        for i in range(4):
            np.testing.assert_allclose(results[i], engine.score_pairs(reqs[i]), atol=1e-6)
    finally:
        gate.set()
        scorer.close()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _serve(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t, f"http://127.0.0.1:{server.server_address[1]}"


def _stop(server, t):
    server.shutdown()
    server.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def test_http_endpoints_and_errors(served):
    _, params, engine = served
    fresh = from_jax_params(jax.tree_util.tree_map(
        np.array, served[0].init(jax.random.PRNGKey(123))))
    server = PPIServer(engine, host="127.0.0.1", port=0, quiet=True, max_pairs=3,
                       reload_cb=lambda: fresh)
    t, base = _serve(server)
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok"
        assert health["model"]["vocab_size"] == VOCAB
        assert health["model"]["trunc_len"] == TRUNC
        assert health["model"]["device"] == "cpu"
        (a1, b1), (a2, b2) = _pairs(5, 2)
        expected = engine.score_pairs([(a1, b1), (a2, b2)])
        st, out = _post(f"{base}/score", {"pairs": [[a1, b1], [a2, b2]]})
        assert st == 200 and "ids" not in out
        np.testing.assert_allclose(out["probabilities"], expected, rtol=1e-6)
        st, out = _post(f"{base}/score", {"pairs": [
            {"seq_a": a1, "seq_b": b1, "id": "x1"}, {"seq_a": a2, "seq_b": b2, "id": "x2"}]})
        assert st == 200 and out["ids"] == ["x1", "x2"]
        for bad, code in (({"pairs": [["only_one"]]}, 400), ({"nope": 1}, 400),
                          ({"pairs": [["A", ""]]}, 400), ({"pairs": [[a1, b1]] * 4}, 413)):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(f"{base}/score", bad)
            assert ei.value.code == code and "error" in json.loads(ei.value.read())
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/nothing", timeout=60)
        assert ei.value.code == 404
        with urllib.request.urlopen(f"{base}/statsz", timeout=60) as r:
            stats = json.loads(r.read())
        assert stats["requests"] == 2 and stats["pairs_scored"] == 4
        assert stats["errors"] == 0 and stats["latency_ms"]["p50"] > 0
        st, out = _post(f"{base}/reload", {})
        assert st == 200 and out == {"reloaded": True}
        st, out = _post(f"{base}/score", {"pairs": [[a1, b1]]})
        assert out["probabilities"][0] != pytest.approx(float(expected[0]), abs=1e-7)
    finally:
        _stop(server, t)
        engine.swap_params(from_jax_params(params))
    server = PPIServer(engine, host="127.0.0.1", port=0, quiet=True, coalesce=False)
    t, base = _serve(server)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"{base}/reload", {})
        assert ei.value.code == 403
    finally:
        _stop(server, t)


def test_serve_start_cpu_matches_jax_engine(served, tmp_path):
    """``serve start --device cpu`` on a .ckpt from the JAX exporter answers
    with the JAX engine's probabilities; ``/reload`` re-reads the file."""
    jnet, params, _ = served
    ckpt = tmp_path / "model.ckpt"
    save_torch_checkpoint(params, ckpt)
    server = Serve.start(
        weights_path=ckpt, spm_path=SPM, host="127.0.0.1", port=0,
        trunc_len=TRUNC, batch_size=4, vocab_size=VOCAB, embedding_size=EMBED,
        allow_reload=True, device="cpu", _block=False,
    )
    t, base = _serve(server)
    try:
        pairs = _pairs(9, 3)
        st, out = _post(f"{base}/score", {"pairs": [list(p) for p in pairs]})
        assert st == 200
        ref = JaxEngine(jnet, params, JaxTokenizer(SPM), trunc_len=TRUNC, batch_size=4)
        np.testing.assert_allclose(out["probabilities"], ref.score_pairs(pairs),
                                   atol=2e-5, rtol=0)
        assert _post(f"{base}/reload", {}) == (200, {"reloaded": True})
    finally:
        _stop(server, t)


def test_serve_cli_surface(monkeypatch):
    from intrepppid_tpu_torch.__main__ import main

    buf = io.StringIO()
    with pytest.raises(SystemExit), redirect_stdout(buf):
        main(["serve", "start", "--help"])
    text = buf.getvalue()
    assert "--weights_path" in text and "--device" in text and "--warmup" in text
    assert "_block" not in text
    # the default device is the card: without one, start refuses to run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["serve", "start", "--weights_path", "unused.ckpt", "--spm_path",
              str(SPM), "--vocab_size", str(VOCAB)])
