"""Compute ops of the port: activations, dropout variants, the LSTM stack
and its kernels, losses, metrics."""
from intrepppid_tpu_torch.ops.lstm import bilstm
from intrepppid_tpu_torch.ops.lstm_recurrence import fused_lstm_recurrence

__all__ = ["bilstm", "fused_lstm_recurrence"]
