"""AWD-LSTM encoder (`intrepppid_tpu/models/awd_lstm.py:47-251`).

Embedding lookup with the padding row zeroed, a bidirectional LSTM stack in
torch weight layout, ``bi_reduce`` over the last layer's two final states
and ``fc``. In training, embedding dropout draws one vocabulary-row mask per
encoder call and weight drop one DropConnect mask of the layer-0 forward
``W_hh`` per call (`intrepppid_tpu/models/awd_lstm.py:131-174, 216-227`);
both are the identity at eval. Variational dropout, which the reference
keeps active at eval, is not ported yet and is rejected.

Truncation is per encoder call, not per row: ``group_max_lengths`` gives
every row of a call-group that group's longest non-pad length, and the
LSTM freezes state past it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from intrepppid_tpu_torch.ops.dropout import dropconnect_weight, embedding_dropout
from intrepppid_tpu_torch.ops.lstm import bilstm

BI_REDUCE_MODES = ("concat", "max", "mean", "last")


@dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 250
    embedding_size: int = 64
    rnn_num_layers: int = 2
    rnn_dropout_rate: float = 0.3
    variational_dropout: bool = False
    bi_reduce: str = "last"
    embedding_droprate: float = 0.3
    include_dead_projection: bool = True
    compute_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.bi_reduce not in BI_REDUCE_MODES:
            raise ValueError(
                f"bi_reduce must be one of {BI_REDUCE_MODES}, got {self.bi_reduce!r}"
            )
        if self.bi_reduce == "concat":
            # the reference feeds the 2E concat into an E->E fc and crashes
            raise ValueError(
                'bi_reduce="concat" is rejected: in the reference it feeds a '
                "2*embedding vector into an embedding->embedding Linear and "
                "crashes; only max/mean/last are viable."
            )
        if self.variational_dropout:
            raise NotImplementedError(
                "variational_dropout (active at eval in the reference) is not "
                "ported yet; see ROADMAP.md"
            )


def uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=gen)


def new_linear(in_dim: int, out_dim: int, gen: torch.Generator) -> nn.Linear:
    """``nn.Linear`` with torch's default init drawn from ``gen``."""
    layer = nn.Linear(in_dim, out_dim)
    bound = 1.0 / in_dim ** 0.5
    uniform_(layer.weight, bound, gen)
    uniform_(layer.bias, bound, gen)
    return layer


def linear(layer: nn.Linear, x: torch.Tensor,
           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ W^T + b`` with f32 accumulation; with ``compute_dtype`` the
    operands are first rounded to it (`intrepppid_tpu/.../awd_lstm.py:84`)."""
    w, b = layer.weight, layer.bias
    if compute_dtype is not None:
        w, x = w.to(compute_dtype), x.to(compute_dtype)
    return F.linear(x.float(), w.float(), b.float())


def group_max_lengths(ids: torch.Tensor, groups: int) -> torch.Tensor:
    """Per-row length vector replicating per-call truncation: ``ids`` is
    group-major ``(G*Bg, T)`` and each group's rows get that group's
    longest non-pad length."""
    B = ids.shape[0]
    lens = (ids != 0).sum(dim=1, dtype=torch.int32)
    if groups <= 1:
        return lens.max().expand(B)
    gmax = lens.view(groups, B // groups).amax(dim=1)
    return gmax.repeat_interleave(B // groups)


class AWDLSTMEncoder(nn.Module):
    """Token ids ``(B, T)`` -> sequence embeddings ``(B, E)``.

    Parameters (torch layout, directions stacked on a leading axis):
    ``embedding (V, E)``; per layer ``lstm.<l>.w_ih (2, 4H, in)``,
    ``w_hh (2, 4H, H)``, ``b_ih``/``b_hh (2, 4H)``; ``fc``; and the
    reference's dead ``projection`` MLP, which is never called but is kept
    so checkpoints map one to one.
    """

    def __init__(self, cfg: EncoderConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        E = H = cfg.embedding_size
        emb = torch.randn(cfg.vocab_size, E, generator=gen)
        emb[0] = 0.0  # padding_idx row
        self.embedding = nn.Parameter(emb)
        bound = 1.0 / H ** 0.5
        layers = []
        for layer in range(cfg.rnn_num_layers):
            in_size = E if layer == 0 else 2 * H
            shapes = {"w_ih": (2, 4 * H, in_size), "w_hh": (2, 4 * H, H),
                      "b_ih": (2, 4 * H), "b_hh": (2, 4 * H)}
            layers.append(nn.ParameterDict({
                k: nn.Parameter(uniform_(torch.empty(s), bound, gen))
                for k, s in shapes.items()
            }))
        self.lstm = nn.ModuleList(layers)
        self.fc = new_linear(E, E, gen)
        if cfg.include_dead_projection:
            # Projection(E, 2E, 3): E -> 4E/3 -> 5E/3 -> 2E with integer steps
            dims, diff = [E], (2 * E - E) // 3
            for _ in range(2):
                dims.append(dims[-1] + diff)
            dims.append(2 * E)
            self.projection = nn.ModuleList(
                [new_linear(a, b, gen) for a, b in zip(dims[:-1], dims[1:])]
            )

    def lstm_weights(self, train: bool, groups: int,
                     gen: Optional[torch.Generator]) -> List[Dict[str, torch.Tensor]]:
        """The stack's weights for one forward. In training with weight drop,
        layer 0's forward ``W_hh`` gets one DropConnect mask per encoder call
        (``w_hh (2, G, 4H, H)``, the reverse direction's matrix broadcast to
        the G calls, so autograd sums its gradient over them)."""
        layers = [dict(lp.items()) for lp in self.lstm]
        p = self.cfg.rnn_dropout_rate
        if not train or p == 0.0:
            return layers
        w_hh = layers[0]["w_hh"]
        if groups > 1:
            fwd = torch.stack([dropconnect_weight(w_hh[0], p, True, gen) for _ in range(groups)])
            layers[0]["w_hh"] = torch.stack([fwd, w_hh[1].expand_as(fwd)])
        else:
            layers[0]["w_hh"] = torch.stack([dropconnect_weight(w_hh[0], p, True, gen), w_hh[1]])
        return layers

    def forward(self, ids: torch.Tensor, groups: int = 1, train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Sequence embeddings ``(B, E)`` for ids ``(B, T)``, the rows being
        ``groups`` stacked encoder calls (group-major). ``train`` turns the
        dropouts on, drawing from ``gen``."""
        cfg = self.cfg
        max_len = group_max_lengths(ids, groups)
        x = embedding_dropout(self.embedding, ids, cfg.embedding_droprate, train, gen,
                              cfg.compute_dtype, groups)
        _, hn, _ = bilstm(self.lstm_weights(train, groups, gen), x, max_len,
                          cfg.compute_dtype)
        # last layer's final states: hn[-2] forward, hn[-1] reverse
        h_fwd, h_bwd = hn[-2], hn[-1]
        if cfg.bi_reduce == "max":
            z = torch.maximum(h_fwd, h_bwd)
        elif cfg.bi_reduce == "mean":
            z = (h_fwd + h_bwd) / 2.0
        else:  # "last": the reverse direction's state after position 0
            z = h_bwd
        return linear(self.fc, z, cfg.compute_dtype)
