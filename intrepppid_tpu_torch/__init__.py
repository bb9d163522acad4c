"""intrepppid_tpu_torch: the PyTorch/CUDA port of intrepppid_tpu for one
NVIDIA H100.

The JAX package ``intrepppid_tpu`` stays the reference that each part of
the port is held against; the port imports nothing of it. The ported slice
so far is the scoring server (``python -m intrepppid_tpu_torch serve
start``), whose bidirectional-LSTM layer runs as a hand-written CUDA kernel
(``csrc/bilstm_fwd.cu``). Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""
__version__ = "0.1.0"

from intrepppid_tpu_torch.models.factory import intrepppid_network

__all__ = ["intrepppid_network", "__version__"]
