"""Model factory (`intrepppid_tpu/models/factory.py:55-98`): the
manuscript ``intrepppid_network()`` with the same defaults, plus the
port's ``device`` (default ``"cuda"``), ``compute_dtype`` (a torch dtype)
and ``seed`` for the initial weights."""
from __future__ import annotations

from typing import List, Union

import torch

from intrepppid_tpu_torch.models.awd_lstm import EncoderConfig
from intrepppid_tpu_torch.models.triplet import TripletE2EConfig, TripletE2ENet
from intrepppid_tpu_torch.utils.device import resolve_device


class IntrepppidNetwork(TripletE2ENet):
    """The network plus the training hyperparameters the factory takes.
    ``step(batch, gen, train)`` is the quintuplet train step's loss
    (``models/triplet.py``); ``train/trainer.py`` drives it."""

    def __init__(self, cfg: TripletE2EConfig, gen: torch.Generator, *,
                 num_epochs: int, steps_per_epoch: int, optimizer_type: str,
                 lr: float):
        super().__init__(cfg, gen)
        self.num_epochs = num_epochs
        self.steps_per_epoch = steps_per_epoch
        self.optimizer_type = optimizer_type
        self.lr = lr

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def param_groups(self) -> List[dict]:
        """Parameters for an optimizer, in two groups. The LSTM tensors stack
        the two directions on a leading axis, where the JAX package and the
        reference keep one tensor per direction: their group is marked
        ``direction_stacked``, so per-tensor optimizer math (Ranger21's unit
        norms and gradient centralisation) treats each direction alone."""
        stacked, rest = [], []
        for name, p in self.named_parameters():
            (stacked if name.startswith("encoder.lstm.") else rest).append(p)
        return [{"params": stacked, "direction_stacked": True},
                {"params": rest, "direction_stacked": False}]


def intrepppid_network(
    steps_per_epoch: int,
    vocab_size: int = 250,
    embedding_size: int = 64,
    rnn_num_layers: int = 2,
    rnn_dropout_rate: float = 0.3,
    variational_dropout: bool = False,
    bi_reduce: str = "last",
    embedding_droprate: float = 0.3,
    num_epochs: int = 100,
    do_rate: float = 0.3,
    beta_classifier: float = 2,
    lr: float = 1e-2,
    use_projection: bool = False,
    optimizer_type: str = "ranger21_xx",
    compute_dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
) -> IntrepppidNetwork:
    """Build the manuscript INTREPPPID network on ``device`` in eval mode,
    with torch's default initialisation drawn from ``seed``."""
    dev = resolve_device(device)
    encoder = EncoderConfig(
        vocab_size=vocab_size,
        embedding_size=embedding_size,
        rnn_num_layers=rnn_num_layers,
        rnn_dropout_rate=rnn_dropout_rate,
        variational_dropout=variational_dropout,
        bi_reduce=bi_reduce,
        embedding_droprate=embedding_droprate,
        compute_dtype=compute_dtype,
    )
    cfg = TripletE2EConfig(
        encoder=encoder,
        do_rate=do_rate,
        beta_classifier=float(beta_classifier),
        use_projection=use_projection,
    )
    gen = torch.Generator().manual_seed(seed)
    net = IntrepppidNetwork(
        cfg, gen, num_epochs=num_epochs, steps_per_epoch=steps_per_epoch,
        optimizer_type=optimizer_type, lr=lr,
    )
    return net.to(dev).eval()
