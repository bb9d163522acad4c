"""The port's LSTM layer kernel wrapper (``intrepppid_tpu_torch/ops/lstm_cuda.py``)
and its plain PyTorch version (``ops/lstm.py:bidir_layer``), without JAX.

On the CPU the wrapper takes its plain version. The tests marked ``cuda``
hold the CUDA kernel against the plain version on the card and skip without
one; this file imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_port_kernel.py -q
"""
import pytest
import torch

from intrepppid_tpu_torch.ops import lstm_cuda
from intrepppid_tpu_torch.ops.lstm import bidir_layer


def test_bilstm_masking_semantics():
    """Frozen state past each row's length: the reverse direction stays at
    zero until position length-1 and a length-0 row keeps zero state."""
    torch.manual_seed(0)
    T, B, H = 6, 3, 4
    x = torch.randn(T, B, H)
    w_ih, w_hh = torch.randn(2, 4 * H, H) * 0.5, torch.randn(2, 4 * H, H) * 0.5
    bias = torch.randn(2, 4 * H)
    lengths = torch.tensor([0, 3, T], dtype=torch.int32)
    hs_f, hs_b, hn, cn = bidir_layer((x,), lengths, w_ih, w_hh, bias, torch.float32)
    assert torch.all(hs_f[:, 0] == 0) and torch.all(hs_b[:, 0] == 0)
    assert torch.all(hn[:, 0] == 0) and torch.all(cn[:, 0] == 0)
    # forward output past the length holds the frozen state
    assert torch.equal(hs_f[3:, 1], hs_f[2:3, 1].expand(T - 3, H))
    assert torch.equal(hn[0, 1], hs_f[2, 1])
    # reverse direction is zero past the length, and ends at position 0
    assert torch.all(hs_b[3:, 1] == 0) and torch.any(hs_b[2, 1] != 0)
    assert torch.equal(hn[1, 1], hs_b[0, 1])
    # a row of length T equals an unmasked run of its own
    full = bidir_layer((x[:, 2:].contiguous(),), torch.tensor([T], dtype=torch.int32),
                       w_ih, w_hh, bias, torch.float32)
    assert torch.equal(full[2][:, 0], hn[:, 2])


def test_wrapper_takes_plain_version_on_cpu():
    torch.manual_seed(1)
    T, B, H = 5, 4, 8
    parts = (torch.randn(T, B, H), torch.randn(T, B, H))
    args = (parts, torch.tensor([5, 0, 2, 4], dtype=torch.int32),
            torch.randn(2, 4 * H, 2 * H), torch.randn(2, 4 * H, H), torch.randn(2, 4 * H))
    before = lstm_cuda.bilstm_layer_fwd.launches
    got = lstm_cuda.bilstm_layer_fwd(*args, torch.float32)
    want = bidir_layer(*args, torch.float32)
    assert lstm_cuda.bilstm_layer_fwd.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize(
    "E_parts,H,dtype,ok",
    [
        ([64], 64, torch.float32, True),
        ([64, 64], 64, torch.float32, True),   # 192 KB of f32 weights fits
        ([64, 64], 64, torch.bfloat16, True),
        ([32, 32], 32, torch.float32, True),
        ([128, 128], 128, torch.float32, False),  # weights past shared memory
        ([60], 64, torch.bfloat16, False),        # not a 16-byte multiple
        ([64], 66, torch.float32, False),
    ],
)
def test_launch_plan(E_parts, H, dtype, ok):
    if not ok:
        with pytest.raises(ValueError, match="bilstm kernel"):
            lstm_cuda.launch_plan(E_parts, H, dtype)
        return
    threads, rows, smem = lstm_cuda.launch_plan(E_parts, H, dtype)
    assert threads % H == 0 and threads <= 256 and rows == threads // H * 4
    assert smem <= lstm_cuda.SMEM_LIMIT


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E_parts,H", [([64], 64), ([64, 64], 64), ([32, 32], 32)])
def test_kernel_matches_plain_on_card(cuda_device, dtype, E_parts, H):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    T, B = 40, 50
    parts = tuple((torch.rand(T, B, e, generator=g, device=cuda_device) * 2 - 1).to(dtype)
                  for e in E_parts)
    w_ih = ((torch.rand(2, 4 * H, sum(E_parts), generator=g, device=cuda_device) - .5) / 4).to(dtype)
    w_hh = ((torch.rand(2, 4 * H, H, generator=g, device=cuda_device) - .5) / 4).to(dtype)
    bias = torch.rand(2, 4 * H, generator=g, device=cuda_device) - .5
    lengths = torch.randint(0, T + 1, (B,), generator=g, device=cuda_device, dtype=torch.int32)
    lengths[:3] = torch.tensor([0, 1, T])
    before = lstm_cuda.bilstm_layer_fwd.launches
    got = lstm_cuda.bilstm_layer_fwd(parts, lengths, w_ih, w_hh, bias, dtype)
    want = bidir_layer(parts, lengths, w_ih, w_hh, bias, dtype)
    torch.cuda.synchronize()
    assert lstm_cuda.bilstm_layer_fwd.launches == before + 1
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) <= tol


@pytest.mark.cuda
def test_kernel_rejects_bad_operands_on_card(cuda_device):
    T, B, H = 4, 3, 64
    parts = (torch.zeros(T, B, H, device=cuda_device),)
    lengths = torch.zeros(B, dtype=torch.int32, device=cuda_device)
    w_ih = torch.zeros(2, 4 * H, H, device=cuda_device)
    w_hh = torch.zeros(2, 4 * H, H, device=cuda_device)
    bias = torch.zeros(2, 4 * H, device=cuda_device)
    with pytest.raises(ValueError, match="bilstm kernel"):
        lstm_cuda.bilstm_layer_fwd(parts, lengths.long(), w_ih, w_hh, bias, torch.float32)
    with pytest.raises(ValueError, match="bilstm kernel"):
        lstm_cuda.bilstm_layer_fwd(parts, lengths, w_ih, w_hh, bias, torch.float16)
