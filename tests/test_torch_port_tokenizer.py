"""The port's copy of the tokenizer (``intrepppid_tpu_torch/data``) gives
the JAX package's token ids, with both its native and its pure-Python
engine, on the in-repo fixture models."""
import json
from pathlib import Path

import numpy as np
import pytest

from intrepppid_tpu.data.tokenizer import SentencePieceTokenizer as JaxTokenizer
from intrepppid_tpu_torch.data.tokenizer import SentencePieceTokenizer
from torch_port_threads import one_thread_one_cpu  # noqa: F401  (autouse)

FIXTURES = Path(__file__).parent / "fixtures"
AAS = "ACDEFGHIKLMNPQRSTVWYXBZU"


def sequences(seed, n=40):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list(AAS), int(rng.integers(1, 260)))) for _ in range(n)]


@pytest.mark.parametrize("model", ["tiny_spm.model", "golden_spm.model"])
@pytest.mark.parametrize("engine", ["native", "python"])
def test_token_ids_match_jax_package(model, engine, monkeypatch):
    ref = JaxTokenizer(FIXTURES / model)
    if engine == "python":
        monkeypatch.setenv("INTREPPPID_TPU_NO_NATIVE", "1")
    tok = SentencePieceTokenizer(FIXTURES / model)
    assert tok.uses_native == (engine == "native")
    seqs = sequences(len(model))
    if model == "golden_spm.model":
        seqs += json.loads((FIXTURES / "golden_spm.json").read_text())["sequences"]
    for s in seqs:
        assert tok.encode(s) == ref.encode(s), s
    np.testing.assert_array_equal(
        tok.encode_batch_padded(seqs, 200, workers=2),
        ref.encode_batch_padded(seqs, 200, workers=2),
    )
    assert tok.vocab_size() == ref.vocab_size()


def test_vocab_validation():
    tok = SentencePieceTokenizer(FIXTURES / "tiny_spm.model")
    tok.validate_vocab_size(38)
    with pytest.raises(ValueError, match="vocab_size"):
        tok.validate_vocab_size(20)
