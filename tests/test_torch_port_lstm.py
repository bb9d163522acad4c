"""The port's bidirectional LSTM (``intrepppid_tpu_torch/ops/lstm.py``)
against the JAX package's ``bilstm``: the scan path, and the Pallas path in
interpret mode, whose eval forward is the packed TPU kernel
``lstm_pallas_packed.py::_fwd_kernel_packed`` (kernel table row 1).

On the CPU the kernel wrapper takes its plain version; the CUDA kernel is
held against that plain version in ``test_torch_port_kernel.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrepppid_tpu.ops import lstm_pallas_packed
from intrepppid_tpu.ops.lstm import bilstm as jax_bilstm
from intrepppid_tpu.ops.lstm import init_lstm_params
from intrepppid_tpu_torch.ops.lstm import bilstm
from torch_port_threads import one_thread_one_cpu  # noqa: F401  (autouse)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# f32: summation order differs; bf16: the layer outputs are rounded to bf16
# (one bf16 ulp at |h| < 1 is 2^-8 ~ 4e-3), and the state may differ by
# rounding flips of the recurrent operand
ATOL = {"float32": 2e-5, "bfloat16": 3e-2}


def port_layers(layers):
    return [
        {k: torch.stack([torch.from_numpy(np.array(lp[d][k])) for d in ("fwd", "bwd")])
         for k in ("w_ih", "w_hh", "b_ih", "b_hh")}
        for lp in layers
    ]


def run_both(B, T, E, lengths, dtype, backend, seed=0):
    jdt, tdt = DTYPES[dtype]
    layers = init_lstm_params(jax.random.PRNGKey(seed), E, E, 2)
    x = np.random.default_rng(seed).standard_normal((B, T, E)).astype(np.float32)
    y, hn, cn = jax_bilstm(layers, jnp.asarray(x), jnp.asarray(lengths), jdt, backend=backend)
    ref = [np.asarray(a.astype(jnp.float32)) for a in (y, hn, cn)]
    got = bilstm(port_layers(layers), torch.from_numpy(x), torch.from_numpy(lengths), tdt)
    return [g.float().numpy() for g in got], ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bilstm_matches_jax_scan(dtype):
    T = 20
    lengths = np.array([0, 1, T, 5, 13, T - 1, 7, 2], np.int32)
    got, ref = run_both(8, T, 16, lengths, dtype, "scan")
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bilstm_matches_packed_pallas_kernel(dtype, monkeypatch):
    """2H == 128 routes the JAX stack through the packed kernel's eval
    variant (``with_states=False``) once per layer."""
    calls = []
    orig = lstm_pallas_packed._fwd_pallas_packed

    def spy(*args, **kwargs):
        calls.append(kwargs.get("with_states"))
        return orig(*args, **kwargs)

    monkeypatch.setattr(lstm_pallas_packed, "_fwd_pallas_packed", spy)
    T = 12
    lengths = np.array([T, 0, 1, 6, T, 11, 3, 9], np.int32)
    got, ref = run_both(8, T, 64, lengths, dtype, "pallas", seed=1)
    assert calls == [False, False]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=ATOL[dtype], rtol=0)
