"""Weights in and out of the port (`intrepppid_tpu/utils/torch_convert.py`
counterpart).

Three layouts meet here:

* the JAX package's params tree (nested dicts of arrays, per-direction LSTM
  weights) — ``from_jax_params`` maps it, as numpy arrays, onto the port's
  ``state_dict``, so both packages can compute with identical weights;
* the reference's PyTorch Lightning ``.ckpt`` key layout, which
  ``python -m intrepppid_tpu export torch_ckpt`` writes and published
  INTREPPPID weights use:

      encoder.embedder.weight
      encoder.encoder.rnn.weight_ih_l{K}[_reverse]
      encoder.encoder.rnn.weight_hh_l0_raw          (weight-dropped)
      encoder.encoder.rnn.weight_hh_l{K}[_reverse]  (all others)
      encoder.encoder.rnn.bias_{ih,hh}_l{K}[_reverse]
      encoder.encoder.fc.{weight,bias}
      encoder.projection.model.{0,2,4}.{weight,bias}   (dead Projection)
      head.classify.fc1.module.{weight_raw,bias}
      head.classify.fc2.module.{weight_raw,bias}
      triplet_projection.1.{weight,bias}               (when use_projection)

* the port's own ``state_dict`` (``models/awd_lstm.py`` names);
  ``to_jax_params`` maps it back to the params tree, from which
  ``save_reference_checkpoint`` writes a reference ``.ckpt`` (``python -m
  intrepppid_tpu_torch export torch_ckpt``).

``load_reference_checkpoint`` also takes a checkpoint directory of the
port's own ``Trainer.fit`` (``train/checkpoint.py``: a ``state.pt`` inside),
as the JAX package's loader takes its own. The JAX package's orbax
checkpoint directories need JAX and orbax to read; convert them with
``python -m intrepppid_tpu export torch_ckpt`` first.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

Params = Dict[str, Any]
_DIRS = (("fwd", ""), ("bwd", "_reverse"))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def from_jax_params(params: Params) -> Dict[str, torch.Tensor]:
    """The JAX package's params tree (numpy leaves) -> the port's
    ``state_dict`` (f32 CPU tensors; ``load_state_dict`` moves them)."""
    enc = params["encoder"]
    sd = {"encoder.embedding": _t(enc["embedding"])}
    for l, lp in enumerate(enc["lstm"]):
        for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
            sd[f"encoder.lstm.{l}.{name}"] = torch.stack(
                [_t(lp["fwd"][name]), _t(lp["bwd"][name])]
            )
    sd["encoder.fc.weight"] = _t(enc["fc"]["w"])
    sd["encoder.fc.bias"] = _t(enc["fc"]["b"])
    for i, p in enumerate(enc.get("projection", [])):
        sd[f"encoder.projection.{i}.weight"] = _t(p["w"])
        sd[f"encoder.projection.{i}.bias"] = _t(p["b"])
    for fc in ("fc1", "fc2"):
        sd[f"head.{fc}.weight"] = _t(params["head"][fc]["w"])
        sd[f"head.{fc}.bias"] = _t(params["head"][fc]["b"])
    if "triplet_projection" in params:
        sd["triplet_projection.weight"] = _t(params["triplet_projection"]["w"])
        sd["triplet_projection.bias"] = _t(params["triplet_projection"]["b"])
    return sd


def to_jax_params(sd: Dict[str, torch.Tensor]) -> Params:
    """Inverse of :func:`from_jax_params`: the port's ``state_dict`` -> a
    params tree in the JAX package's layout (f32 numpy leaves). A network
    built without ``use_projection`` has no ``triplet_projection``, and
    neither has the tree."""
    n_layers = len({k.split(".")[2] for k in sd if k.startswith("encoder.lstm.")})
    n_proj = len([k for k in sd if k.startswith("encoder.projection.")
                  and k.endswith(".weight")])
    encoder: Params = {
        "embedding": _np(sd["encoder.embedding"]),
        "lstm": [
            {d: {name: _np(sd[f"encoder.lstm.{l}.{name}"][i])
                 for name in ("w_ih", "w_hh", "b_ih", "b_hh")}
             for i, d in enumerate(("fwd", "bwd"))}
            for l in range(n_layers)
        ],
        "fc": {"w": _np(sd["encoder.fc.weight"]), "b": _np(sd["encoder.fc.bias"])},
    }
    if n_proj:
        encoder["projection"] = [
            {"w": _np(sd[f"encoder.projection.{i}.weight"]),
             "b": _np(sd[f"encoder.projection.{i}.bias"])}
            for i in range(n_proj)
        ]
    params: Params = {
        "encoder": encoder,
        "head": {fc: {"w": _np(sd[f"head.{fc}.weight"]), "b": _np(sd[f"head.{fc}.bias"])}
                 for fc in ("fc1", "fc2")},
    }
    if "triplet_projection.weight" in sd:
        params["triplet_projection"] = {"w": _np(sd["triplet_projection.weight"]),
                                        "b": _np(sd["triplet_projection.bias"])}
    return params


def reference_to_params(sd: Dict[str, Any], rnn_num_layers: int = 2) -> Params:
    """A reference ``state_dict`` -> a params tree in the JAX package's
    layout (numpy leaves)."""
    lstm = []
    for layer in range(rnn_num_layers):
        lp = {}
        for direction, suffix in _DIRS:
            hh = f"encoder.encoder.rnn.weight_hh_l{layer}{suffix}"
            if hh + "_raw" in sd:  # the weight-dropped matrix
                hh += "_raw"
            lp[direction] = {
                "w_ih": _np(sd[f"encoder.encoder.rnn.weight_ih_l{layer}{suffix}"]),
                "w_hh": _np(sd[hh]),
                "b_ih": _np(sd[f"encoder.encoder.rnn.bias_ih_l{layer}{suffix}"]),
                "b_hh": _np(sd[f"encoder.encoder.rnn.bias_hh_l{layer}{suffix}"]),
            }
        lstm.append(lp)
    encoder: Params = {
        "embedding": _np(sd["encoder.embedder.weight"]),
        "lstm": lstm,
        "fc": {"w": _np(sd["encoder.encoder.fc.weight"]),
               "b": _np(sd["encoder.encoder.fc.bias"])},
    }
    if "encoder.projection.model.0.weight" in sd:
        encoder["projection"] = [
            {"w": _np(sd[f"encoder.projection.model.{i}.weight"]),
             "b": _np(sd[f"encoder.projection.model.{i}.bias"])}
            for i in (0, 2, 4)
        ]
    params: Params = {
        "encoder": encoder,
        "head": {
            fc: {"w": _np(sd[f"head.classify.{fc}.module.weight_raw"]),
                 "b": _np(sd[f"head.classify.{fc}.module.bias"])}
            for fc in ("fc1", "fc2")
        },
    }
    if "triplet_projection.1.weight" in sd:
        params["triplet_projection"] = {
            "w": _np(sd["triplet_projection.1.weight"]),
            "b": _np(sd["triplet_projection.1.bias"]),
        }
    return params


def params_to_reference(params: Params) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`reference_to_params`. Like the JAX exporter it
    emits the LSTM under both of the reference's registration paths
    (``rnn`` and ``rnn_dp.module``), so the reference can load it strictly."""
    enc = params["encoder"]
    sd = {"encoder.embedder.weight": _t(enc["embedding"])}
    for layer, lp in enumerate(enc["lstm"]):
        for direction, suffix in _DIRS:
            hh = f"weight_hh_l{layer}{suffix}"
            if layer == 0 and direction == "fwd":
                hh += "_raw"
            dp = lp[direction]
            for name, arr in ((f"weight_ih_l{layer}{suffix}", dp["w_ih"]),
                              (hh, dp["w_hh"]),
                              (f"bias_ih_l{layer}{suffix}", dp["b_ih"]),
                              (f"bias_hh_l{layer}{suffix}", dp["b_hh"])):
                sd[f"encoder.encoder.rnn.{name}"] = _t(arr)
                sd[f"encoder.encoder.rnn_dp.module.{name}"] = _t(arr)
    sd["encoder.encoder.fc.weight"] = _t(enc["fc"]["w"])
    sd["encoder.encoder.fc.bias"] = _t(enc["fc"]["b"])
    if "projection" not in enc:
        raise ValueError(
            "params have no dead-Projection weights (include_dead_projection=False), "
            "but the reference module tree requires encoder.projection.* for a "
            "strict load_state_dict")
    for i, idx in enumerate((0, 2, 4)):
        sd[f"encoder.projection.model.{idx}.weight"] = _t(enc["projection"][i]["w"])
        sd[f"encoder.projection.model.{idx}.bias"] = _t(enc["projection"][i]["b"])
    for fc in ("fc1", "fc2"):
        sd[f"head.classify.{fc}.module.weight_raw"] = _t(params["head"][fc]["w"])
        sd[f"head.classify.{fc}.module.bias"] = _t(params["head"][fc]["b"])
    if "triplet_projection" in params:
        sd["triplet_projection.1.weight"] = _t(params["triplet_projection"]["w"])
        sd["triplet_projection.1.bias"] = _t(params["triplet_projection"]["b"])
    return sd


def save_reference_checkpoint(params: Params, path,
                              hyper_parameters: Optional[Dict[str, Any]] = None,
                              epoch: Optional[int] = None,
                              global_step: Optional[int] = None) -> int:
    """Write ``params`` (JAX layout) as a reference-layout ``.ckpt``, as the
    JAX package's ``save_torch_checkpoint`` does: f32 CPU tensors under
    ``state_dict``, and ``hyper_parameters``, ``epoch`` and ``global_step``
    where given. Returns the number of ``state_dict`` entries."""
    sd = params_to_reference(params)
    chkpt: Dict[str, Any] = {"state_dict": sd}
    if hyper_parameters is not None:
        chkpt["hyper_parameters"] = dict(hyper_parameters)
    if epoch is not None:
        chkpt["epoch"] = int(epoch)
    if global_step is not None:
        chkpt["global_step"] = int(global_step)
    torch.save(chkpt, path)
    return len(sd)


def orbax_refusal(path) -> ValueError:
    """The error for a directory that is not a checkpoint of the port: an
    orbax checkpoint of the JAX package, which needs JAX to read."""
    return ValueError(
        f"{path} is a directory — an orbax checkpoint of the JAX package, "
        "which needs JAX to read. Convert it first with `python -m "
        "intrepppid_tpu export torch_ckpt --checkpoint_path "
        f"{path} --out_path model.ckpt` and serve the .ckpt."
    )


def load_reference_checkpoint(path, rnn_num_layers: int = 2) -> Dict[str, torch.Tensor]:
    """Read a reference-layout ``.ckpt``, or a checkpoint directory of the
    port's ``Trainer.fit``, into the port's ``state_dict`` (CPU tensors).

    Only tensors and plain containers are unpickled (``weights_only``)."""
    path = Path(path)
    if path.is_dir():
        from intrepppid_tpu_torch.train.checkpoint import (
            is_checkpoint,
            load_params_from_checkpoint,
        )

        if is_checkpoint(path):
            return load_params_from_checkpoint(path)
        raise orbax_refusal(path)
    chkpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = chkpt.get("state_dict", chkpt)
    return from_jax_params(reference_to_params(sd, rnn_num_layers))


def load_weights(net: torch.nn.Module, state_dict: Dict[str, torch.Tensor]) -> None:
    """Load ``state_dict`` into ``net`` strictly, except that a state without
    ``triplet_projection`` (a network trained with ``use_projection=False``)
    keeps the net's own: the scorers build the net with one, as the
    reference does, and the pair forward never reads it. The JAX package's
    params tree simply lacks it there."""
    missing, unexpected = net.load_state_dict(state_dict, strict=False)
    missing = [k for k in missing if not k.startswith("triplet_projection.")]
    if missing or unexpected:
        raise RuntimeError(f"the weights do not fit the network: missing {missing}, "
                           f"unexpected {unexpected}")
