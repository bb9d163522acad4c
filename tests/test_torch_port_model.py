"""The port's network (``intrepppid_tpu_torch/models``) against the JAX
package's ``net.forward`` with identical params, and checkpoint loading."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrepppid_tpu.models.factory import intrepppid_network as jax_network
from intrepppid_tpu.utils.torch_convert import save_torch_checkpoint
from intrepppid_tpu_torch.models.awd_lstm import EncoderConfig, group_max_lengths
from intrepppid_tpu_torch.models.factory import intrepppid_network
from intrepppid_tpu_torch.ops.dropout import embedding_lookup
from intrepppid_tpu_torch.utils.convert import from_jax_params, load_reference_checkpoint
from torch_port_threads import one_thread_one_cpu  # noqa: F401  (autouse)

VOCAB, EMBED = 38, 16


def jax_params(net, seed):
    return jax.tree_util.tree_map(np.array, net.init(jax.random.PRNGKey(seed)))


def padded_ids(seed, B=5, T=30):
    rng = np.random.default_rng(seed)
    x1 = rng.integers(1, VOCAB, (B, T)).astype(np.int32)
    x2 = rng.integers(1, VOCAB, (B, T)).astype(np.int32)
    # p1 and p2 get different call-group maxima (per-call truncation)
    for i, n in enumerate([0, 1, 5, 20, 24][:B]):
        x1[i, n:] = 0
    for i, n in enumerate([3, T, 0, 12, 7][:B]):
        x2[i, n:] = 0
    return x1, x2


@pytest.mark.parametrize("bi_reduce", ["last", "max", "mean"])
def test_forward_matches_jax(bi_reduce):
    jnet = jax_network(0, vocab_size=VOCAB, embedding_size=EMBED,
                       use_projection=True, bi_reduce=bi_reduce)
    params = jax_params(jnet, 0)
    net = intrepppid_network(0, vocab_size=VOCAB, embedding_size=EMBED,
                             use_projection=True, bi_reduce=bi_reduce, device="cpu")
    net.load_state_dict(from_jax_params(params))
    x1, x2 = padded_ids(1)
    want = np.asarray(jnet.forward(params, jnp.asarray(x1), jnp.asarray(x2)))
    with torch.no_grad():
        got = net(torch.from_numpy(x1), torch.from_numpy(x2)).numpy()
    assert got.shape == want.shape == (5, 1)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_bf16_forward_matches_jax():
    jnet = jax_network(0, vocab_size=VOCAB, embedding_size=EMBED,
                       use_projection=True, compute_dtype=jnp.bfloat16)
    params = jax_params(jnet, 4)
    net = intrepppid_network(0, vocab_size=VOCAB, embedding_size=EMBED,
                             use_projection=True, compute_dtype=torch.bfloat16,
                             device="cpu")
    net.load_state_dict(from_jax_params(params))
    x1, x2 = padded_ids(5)
    want = np.asarray(jnet.forward(params, jnp.asarray(x1), jnp.asarray(x2)))
    with torch.no_grad():
        got = net(torch.from_numpy(x1), torch.from_numpy(x2)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=0)


def test_concat_rejected_and_train_not_ported():
    """``concat`` stays rejected; the train forward is ported now: with
    dropout on it is stochastic, with the rates at 0 it equals eval."""
    with pytest.raises(ValueError, match="concat"):
        EncoderConfig(bi_reduce="concat")
    with pytest.raises(ValueError, match="bi_reduce"):
        EncoderConfig(bi_reduce="sum")
    net = intrepppid_network(0, vocab_size=VOCAB, embedding_size=EMBED, device="cpu")
    x1, x2 = (torch.from_numpy(a) for a in padded_ids(8))
    with torch.no_grad():
        eval_logits = net(x1, x2)
        a = net(x1, x2, train=True, gen=torch.Generator().manual_seed(0))
        b = net(x1, x2, train=True, gen=torch.Generator().manual_seed(1))
    assert torch.all(torch.isfinite(a)) and not torch.equal(a, b)
    quiet = intrepppid_network(0, vocab_size=VOCAB, embedding_size=EMBED, device="cpu",
                               rnn_dropout_rate=0.0, embedding_droprate=0.0, do_rate=0.0)
    with torch.no_grad():
        assert torch.equal(quiet(x1, x2, train=True), eval_logits)


def test_group_max_lengths_is_per_call():
    ids = torch.tensor([[1, 1, 0, 0], [1, 0, 0, 0], [1, 1, 1, 1], [0, 0, 0, 0]])
    assert group_max_lengths(ids, 2).tolist() == [2, 2, 4, 4]
    assert group_max_lengths(ids, 1).tolist() == [4, 4, 4, 4]


def test_padding_row_is_zero_even_when_table_row_is_not():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3) + 1
    ids = torch.tensor([[0, 2, 0, 3]])
    out = embedding_lookup(table, ids, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert torch.all(out[0, 0] == 0) and torch.all(out[0, 2] == 0)
    assert torch.equal(out[0, 1].float(), table[2])


def test_nonzero_padding_row_matches_jax():
    """A converted checkpoint may carry a non-zero row 0; both packages zero
    the lookup of id 0 regardless."""
    jnet = jax_network(0, vocab_size=VOCAB, embedding_size=EMBED, use_projection=True)
    params = jax_params(jnet, 2)
    params["encoder"]["embedding"][0] = 0.5
    net = intrepppid_network(0, vocab_size=VOCAB, embedding_size=EMBED,
                             use_projection=True, device="cpu")
    net.load_state_dict(from_jax_params(params))
    x1, x2 = padded_ids(3)
    want = np.asarray(jnet.forward(params, jnp.asarray(x1), jnp.asarray(x2)))
    with torch.no_grad():
        got = net(torch.from_numpy(x1), torch.from_numpy(x2)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_reference_ckpt_loads_with_same_logits(tmp_path):
    """A .ckpt written by the JAX package's exporter loads into the port and
    gives the JAX logits; an orbax directory is refused with a pointer."""
    jnet = jax_network(0, vocab_size=VOCAB, embedding_size=EMBED, use_projection=True)
    params = jax_params(jnet, 6)
    path = tmp_path / "model.ckpt"
    save_torch_checkpoint(params, path, hyper_parameters={"lr": 0.01}, epoch=3)
    net = intrepppid_network(0, vocab_size=VOCAB, embedding_size=EMBED,
                             use_projection=True, device="cpu")
    net.load_state_dict(load_reference_checkpoint(path))
    x1, x2 = padded_ids(7)
    want = np.asarray(jnet.forward(params, jnp.asarray(x1), jnp.asarray(x2)))
    with torch.no_grad():
        got = net(torch.from_numpy(x1), torch.from_numpy(x2)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    with pytest.raises(ValueError, match="export torch_ckpt"):
        load_reference_checkpoint(tmp_path)


def test_state_dict_keys_map_one_to_one():
    jnet = jax_network(0, vocab_size=VOCAB, embedding_size=EMBED, use_projection=True)
    sd = from_jax_params(jax_params(jnet, 0))
    net = intrepppid_network(0, vocab_size=VOCAB, embedding_size=EMBED,
                             use_projection=True, device="cpu")
    assert set(sd) == set(net.state_dict())
    for k, v in net.state_dict().items():
        assert sd[k].shape == v.shape, k
    n_jax = sum(int(np.size(a)) for a in jax.tree_util.tree_leaves(jax_params(jnet, 0)))
    assert net.num_params() == n_jax
